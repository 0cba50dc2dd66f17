"""The port's LM refinement (refine/gauss_newton.py) against the JAX
package's: the Jacobian of the residuals w.r.t. the local step against
``jax.jacfwd`` of the reference's ``local_residual``, and ``refine_pairs``
on seeded candidates.

Tolerances. Against jacfwd evaluated one primitive at a time
(``jax.disable_jit``: every multiply and add rounded once) the Jacobian and
the residuals are bit-equal: the port writes the chain in the reference's
operand order. Against the compiled jacfwd they agree within 32 ulps of
the lane's largest entry (20 seen): XLA's CPU backend contracts
multiply-add pairs into FMAs inside its fusions, where the port rounds
each product, and which pairs it contracts depends on how the program is
compiled (the reference's vmapped and per-lane compilations differ from
each other by as much). ``refine_pairs`` on well-conditioned candidates
(12 pairs of planes in general position) agrees within 2e-6. The ops of
one LM iteration are counted too (each a kernel launch on the card).

The loop's two forms (``lm_loop``): run to the cap with no host read and
with the early exit (the CPU's) are bit-equal, also with zero-weight
lanes, a lane at zero cost and a NaN lane, and the first reads nothing
back to the host. ``lm_loop`` is the plain version of the CUDA kernel L1
(``refine/lm_kernel.py``, ``csrc/lm.cu``), which ``refine_pairs`` takes
for CUDA tensors; CPU tensors take ``lm_loop`` and launch nothing, and
any other device raises. L1 itself is held to ``lm_loop`` bit for bit on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fccf_pcr_tpu.ops import geometry as jgeo
from fccf_pcr_tpu.refine import gauss_newton as jgn
from fccf_pcr_torch.refine import gauss_newton as tgn
from fccf_pcr_torch.refine import lm_kernel


def _unit(rng, shape):
    v = rng.normal(size=shape)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _lm_inputs(seed, B=8, P=16):
    """Random unit q, t, planes, weights with zeros."""
    rng = np.random.default_rng(seed)
    q = _unit(rng, (B, 4))
    t = rng.normal(0, 2, (B, 3))
    n1, n2 = _unit(rng, (B, P, 3)), _unit(rng, (B, P, 3))
    p1, p2 = rng.uniform(-10, 10, (B, P, 3)), rng.uniform(-10, 10, (B, P, 3))
    w = rng.uniform(0, 0.2, (B, P))
    w[rng.uniform(size=(B, P)) < 0.3] = 0.0
    return [a.astype(np.float32) for a in (q, t, n1, p1, n2, p2, w)]


def _local_residual(delta, q, t, n1, p1, n2, p2, w):
    """The reference's LM residual of the local step (refine_pairs'
    closure, fccf_pcr_tpu/refine/gauss_newton.py)."""
    dq = jgn._exp_quat(delta[:3])
    return jgn._residuals(
        jgeo.quat_multiply(dq, q), t + delta[3:], n1, p1, n2, p2, w
    ).reshape(-1)


def _reference(q, t, n1, p1, n2, p2, w):
    zero = jnp.zeros(6, jnp.float32)
    r = _local_residual(zero, q, t, n1, p1, n2, p2, w)
    J = jax.jacfwd(_local_residual)(zero, q, t, n1, p1, n2, p2, w)
    return r, J


def _port(q, t, n1, p1, n2, p2, w):
    q, t, n1, p1, n2, p2, w = map(torch.from_numpy, (q, t, n1, p1, n2, p2, w))
    n1p1 = torch.sum(n1 * p1, dim=-1)
    r, J = tgn._residuals_and_jacobian(q, t, n1, n1p1, n2, p2, w)
    return r.numpy(), J.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jacobian_bit_equal_to_jacfwd_op_by_op(seed):
    args = _lm_inputs(seed, B=3)
    r, J = _port(*args)
    with jax.disable_jit():
        for b in range(3):
            rj, Jj = _reference(*(a[b] for a in args))
            np.testing.assert_array_equal(r[b], np.asarray(rj))
            np.testing.assert_array_equal(J[b], np.asarray(Jj))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_jacobian_matches_compiled_jacfwd(seed):
    args = _lm_inputs(seed)
    r, J = _port(*args)
    rj, Jj = (np.asarray(x) for x in jax.jit(jax.vmap(_reference))(*args))
    assert J.shape == Jj.shape == (8, 64, 6)
    scale = np.abs(Jj).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(J - Jj) <= 32 * np.spacing(scale))
    r_scale = np.abs(rj).max(axis=1, keepdims=True)
    assert np.all(np.abs(r - rj) <= 32 * np.spacing(r_scale))
    # rows of zero-weight pairs are exactly zero in both
    zero_rows = np.repeat(args[6] == 0, 4, axis=1)
    assert np.all(J[zero_rows] == 0) and np.all(Jj[zero_rows] == 0)


def _candidates(seed, B=6, P=16, n_pairs=12):
    """Plane pairs under a small per-lane pose error, 12 valid pairs in
    general position (a well-conditioned LM problem), 4 masked."""
    rng = np.random.default_rng(seed)
    n1 = _unit(rng, (B, P, 3))
    p1 = rng.uniform(-5, 5, (B, P, 3))
    ang = rng.normal(0, 0.03, (B, 3))
    q = np.concatenate([np.ones((B, 1)), ang / 2], axis=1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = np.asarray(jgeo.quat_to_matrix(jnp.asarray(q, jnp.float32)))
    n2 = np.einsum("bij,bpj->bpi", R, n1)
    p2 = np.einsum("bij,bpj->bpi", R, p1) + rng.normal(0, 0.05, (B, 1, 3))
    w = rng.uniform(0.05, 0.2, (B, P))
    w[:, n_pairs:] = 0.0
    return [a.astype(np.float32) for a in (n1, p1, n2, p2, w)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_pairs_matches_reference(seed):
    args = _candidates(seed)
    j = np.asarray(jax.jit(jax.vmap(lambda *a: jgn.refine_pairs(*a)))(*args))
    t = tgn.refine_pairs(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-6)
    assert not np.allclose(j, np.eye(4), atol=1e-3)  # the LM moved


@pytest.mark.parametrize("F", [33, 64, 4097])
def test_refine_pairs_matches_reference_above_32_planes(F):
    """More plane pairs a lane than a warp has threads (L1 takes them
    through its scratch buffer on a card), up to 4097 (beyond the 4096
    L1 once capped): refine_pairs (lm_loop with its early exit) and
    lm_loop to its cap on the CPU against the JAX refine_pairs on the
    same planes, within 2e-6 as at 16 planes; the two loop forms
    bit-equal."""
    args = _candidates(F, P=F, n_pairs=F - F // 4)
    j = np.asarray(jax.jit(jax.vmap(lambda *a: jgn.refine_pairs(*a)))(*args))
    ta = [torch.from_numpy(a) for a in args]
    t = tgn.refine_pairs(*ta).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(
        tgn.lm_loop(*ta, early_exit=False).numpy(), t)
    assert not np.allclose(j, np.eye(4), atol=1e-3)  # the LM moved


class _CountLaunches(TorchDispatchMode):
    """Counts the aten ops that compute (views excluded): on the card,
    one kernel launch each."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_lm_iteration_launches():
    """The LM loop is bound by kernel launches on the card (PERF.md
    section 5), so the ops of one iteration are pinned: 432 with the
    Jacobian written out as forward-mode AD forms it, one residual helper
    shared with the step's cost, J^T J, J^T r and the two costs as fixed
    pairwise sums (the same rounding in every batch; 412 with two matrix
    products and the costs as one torch.sum each, 422 with the costs so)
    and the cross tangent's index permutations as rolls (no index list
    copied to the card), against 455 for the closed-form Jacobian it
    replaced (same count)."""
    args = [torch.from_numpy(a) for a in _candidates(3, B=12)]
    counts = []
    for iters in (1, 2, 3):
        with _CountLaunches() as c:
            tgn.refine_pairs(*args, iters=iters)
        counts.append(c.n)
    per_iteration = counts[2] - counts[1]
    assert per_iteration == counts[1] - counts[0]  # every lane still runs
    assert per_iteration == 432


def _edge_lanes(seed, B=6, P=16, noisy=True):
    """_candidates' lanes, ``noisy`` with 5 cm of noise on the points and
    about 1 deg on the normals (so a lane can meet the 1e-6 tolerance and
    stop), the last three replaced by a lane of zero weights, a lane at
    exactly zero cost (each plane its own match, so the identity is
    exact) and a lane with a NaN point."""
    n1, p1, n2, p2, w = _candidates(seed, B=B, P=P)
    if noisy:
        rng = np.random.default_rng(100 + seed)
        p2 = (p2 + rng.normal(0, 0.05, p2.shape)).astype(np.float32)
        n2 = n2 + rng.normal(0, 0.02, n2.shape)
        n2 = (n2 / np.linalg.norm(n2, axis=-1, keepdims=True)).astype(
            np.float32)
    w[B - 3] = 0.0
    n2[B - 2], p2[B - 2] = n1[B - 2], p1[B - 2]
    p1[B - 1, 5, 1] = np.nan
    return [n1, p1, n2, p2, w]


class _NoHostRead(TorchDispatchMode):
    """Fails on any op that reads a tensor back as a Python value (on the
    card, a host sync); counts the ops that compute."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.is_nonzero.default):
            raise AssertionError(f"host read: {func}")
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("seed,exits_early", [
    (0, True), (1, False), (3, True), (4, True), (6, True)])
def test_loop_to_the_cap_equals_early_exit(seed, exits_early):
    """Run to the cap, the loop returns the early exit's bits, whether
    the early exit stops before the cap (seeds 0, 3, 4, 6: every live
    lane met its tolerance) or not (seed 1)."""
    args = [torch.from_numpy(a) for a in _edge_lanes(seed)]
    with _CountLaunches() as early_ops:
        early = tgn.lm_loop(*args)
    with _CountLaunches() as cap_ops:
        cap = tgn.lm_loop(*args, early_exit=False)
    assert torch.equal(early, cap)
    assert (early_ops.n < cap_ops.n - 1000) == exits_early
    # the zero-weight, zero-cost and NaN lanes keep the identity
    assert torch.equal(cap[-3:], torch.eye(4).expand(3, 4, 4))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loop_to_the_cap_matches_reference(seed):
    """As test_refine_pairs_matches_reference, with the three edge lanes
    in the batch."""
    args = _edge_lanes(seed, B=9, noisy=False)
    j = np.asarray(jax.jit(jax.vmap(lambda *a: jgn.refine_pairs(*a)))(*args))
    t = tgn.lm_loop(*(torch.from_numpy(a) for a in args),
                    early_exit=False).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-6)
    assert not np.allclose(j[:-3], np.eye(4), atol=1e-3)  # the LM moved


def test_loop_to_the_cap_reads_nothing_back():
    """No op of the loop run to its cap reads a value back to the host
    (on the card: no host sync, so it can be captured); the early exit
    does, once an iteration."""
    args = [torch.from_numpy(a) for a in _edge_lanes(4)]
    with _NoHostRead() as mode:
        tgn.lm_loop(*args, early_exit=False)
    assert mode.n > 50 * 400
    with pytest.raises(AssertionError, match="host read"):
        with _NoHostRead():
            tgn.lm_loop(*args)


def test_refine_pairs_takes_lm_loop_on_the_cpu(monkeypatch):
    """CPU tensors take the plain loop with its early exit (the same bits
    as before the kernel existed) and launch no kernel: L1's launch count
    stays, and nothing builds it."""
    monkeypatch.setattr(lm_kernel, "build", lambda force=False: pytest.fail(
        "the CPU path built the CUDA library"))
    args = [torch.from_numpy(a) for a in _edge_lanes(2)]
    before = lm_kernel.LAUNCHES
    got = tgn.refine_pairs(*args, iters=20)
    assert lm_kernel.LAUNCHES == before
    assert torch.equal(got, tgn.lm_loop(*args, iters=20))
    assert torch.equal(got, lm_kernel.refine_lm(*args, iters=20))


def test_refine_pairs_refuses_other_devices():
    """A tensor on neither the CPU nor a card raises; nothing falls
    back."""
    n = torch.zeros((2, 4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgn.refine_pairs(n, n, n, n, torch.zeros((2, 4), device="meta"))


@pytest.mark.parametrize("case,match", [
    ("cpu", "unsupported device cpu"),
    ("planes", "F = 0"),
    ("dtype", "n1 wants float32"), ("shape", "n2 wants"),
    ("iters", "iters = -1"), ("registers", "does not fit in registers")])
def test_lm_solve_refuses_what_the_kernel_does_not_take(case, match):
    """The kernel's wrapper checks before it builds or launches: CUDA
    float32 (Bt, F, 3) planes and (Bt, F) weights, F >= 1 (no cap above),
    iters >= 0, and the registers instantiation only up to REG_PLANES
    (each check fails before any CUDA call, so on the CPU too)."""
    Bt, F, iters, dtype = 2, 4, 5, torch.float32
    registers = None
    if case == "planes":
        F = 0
    if case == "registers":
        F, registers = lm_kernel.REG_PLANES + 1, True
    if case == "iters":
        iters = -1
    if case == "dtype":
        dtype = torch.float64
    planes = [torch.zeros((Bt, F, 3), dtype=dtype) for _ in range(4)]
    w = torch.zeros((Bt, F), dtype=dtype)
    if case == "shape":
        planes[2] = torch.zeros((Bt, F + 1, 3))
    before = lm_kernel.LAUNCHES
    with pytest.raises(ValueError, match=match):
        lm_kernel.lm_solve(*planes, w, iters, registers=registers)
    assert lm_kernel.LAUNCHES == before


def test_kernel_limits_match_the_source():
    """The wrapper's REG_PLANES is the source's kRegPlanes, the source
    caps no other number of planes, and the build keeps every product
    rounded once (--fmad=false) and never uses fast math, which lm_loop's
    bits need."""
    import re

    from fccf_pcr_torch.ops import cuda_build

    src = lm_kernel._LIBRARY.source.read_text()
    assert int(re.search(r"kRegPlanes = (\d+);", src).group(1)) == \
        lm_kernel.REG_PLANES
    assert "kMaxPlanes" not in src
    assert "--fmad=false" in cuda_build.NVCC_FLAGS
    assert not any("fast" in f for f in cuda_build.NVCC_FLAGS)
    for fast in ("__fdividef", "rsqrtf", "__sinf", "__cosf", "__expf"):
        assert fast not in src, fast


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_rounds_alike_in_any_batch(seed):
    """A lane of lm_loop gives the same bits alone (Bt = 1), in a batch of
    12 and in one of 96 built from the same planes: every sum of the loop
    (the costs, J^T J, J^T r) adds in an order fixed by one lane's shape.
    The batch holds noisy lanes, a zero-weight, a zero-cost and a NaN
    lane."""
    parts = [_edge_lanes(seed * 8 + k, B=12) for k in range(8)]
    args = [torch.from_numpy(np.concatenate([p[i] for p in parts]))
            for i in range(5)]
    assert args[4].shape == (96, 16)
    full = tgn.lm_loop(*args, early_exit=False)
    twelve = tgn.lm_loop(*(a[24:36] for a in args), early_exit=False)
    assert torch.equal(twelve, full[24:36])
    for lane in (0, 9, 10, 11, 30, 95):
        alone = tgn.lm_loop(*(a[lane:lane + 1] for a in args),
                            early_exit=False)
        assert torch.equal(alone[0], full[lane]), lane
