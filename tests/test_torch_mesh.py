"""The port's pair-axis split (fccf_pcr_torch/parallel/mesh.py) and
run_sweep's use of it, on the CPU: a device listed k times stands in for
k devices.

A split is exact: every field of the split batch is bitwise equal to the
unsplit batch's, on [cpu] * 2, [cpu] * 4 and over two host threads. Against the JAX package's
make_sharded_register_fn on conftest's 8-virtual-device CPU mesh: the
tests/test_torch_pipeline.py bands (transform within 0.1 deg / 0.02 m;
status, counts and kept mask exact; scores rtol 1e-3 / atol 1e-5).
sharded_mean_errors against the whole batch's mean errors, and against the
JAX one at tests/test_torch_sweep.py's RRE/RTE bands. run_sweep splits over
every card (mesh.make_mesh()); here make_mesh is patched to list the CPU
k times."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fccf_pcr_tpu.io import synthetic
from fccf_pcr_tpu.parallel import mesh as jmesh
from fccf_pcr_tpu.pipeline import sweep as jsweep
from fccf_pcr_torch import interop, make_register_fn
from fccf_pcr_torch.parallel import mesh as tmesh
from fccf_pcr_torch.pipeline import sweep as tsweep
from test_torch_pipeline import assert_result_matches


def _cards(monkeypatch, k):
    """run_sweep's mesh of every card, as the CPU listed k times."""
    monkeypatch.setattr(tmesh, "make_mesh",
                        lambda devices=None: [torch.device("cpu")] * k)


def _port(params, caps):
    return (interop.params_from_reference(dataclasses.asdict(params)),
            interop.caps_from_reference(dataclasses.asdict(caps)))


@pytest.fixture(scope="module")
def batch8(caps):
    """tests/test_sweep.py's three pairs, repeated to a batch of 8, with
    their ground truth."""
    pairs, gts = [], []
    for s in (11, 12, 13):
        src, tar, T = synthetic.make_pair(
            seed=s, points_per_plane=800, clutter_points=400,
            room=(8.0, 6.0, 3.0))
        pairs.append(synthetic.pad_points(src, caps.max_points)
                     + synthetic.pad_points(tar, caps.max_points))
        gts.append(T)
    pairs, gts = (pairs * 3)[:8], (gts * 3)[:8]
    return [np.stack([p[k] for p in pairs]) for k in range(4)], np.stack(gts)


@pytest.fixture(scope="module")
def unsplit(params, caps, batch8):
    args, _ = batch8
    return make_register_fn(*_port(params, caps), batched=True,
                            device="cpu")(*args)


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu"] * 4,
                                     ["cpu", "cpu:0"]],
                         ids=["cpu*2", "cpu*4", "two_threads"])
def test_split_is_bitwise_equal_to_unsplit(params, caps, batch8, unsplit,
                                           devices):
    """One device listed k times runs its chunks in turn; "cpu" and
    "cpu:0" are two distinct devices, so their chunks run in two host
    threads at once."""
    args, _ = batch8
    mesh = tmesh.make_mesh(devices)
    assert mesh == [torch.device(d) for d in devices]
    got = tmesh.make_sharded_register_fn(*_port(params, caps), mesh)(*args)
    for name, a, b in zip(got._fields, got, unsplit):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), f"{name} differs between split and unsplit"


def test_sharded_pre_downsample_chunks_equal_whole(params, caps, batch8):
    """pre_downsample with the pair axis over [cpu] * 2: each chunk equals
    its rows of the whole batch's, bit for bit, and the sharded function
    takes the chunks where they lie."""
    from fccf_pcr_torch import pre_downsample

    (sp, sm, tp, tm), _ = batch8
    tparams, tcaps = _port(params, caps)
    mesh = tmesh.make_mesh(["cpu"] * 2)
    chunks = []
    for pts, mask in ((sp, sm), (tp, tm)):
        whole = pre_downsample(pts, mask, tparams, tcaps, device="cpu")
        got = tmesh.sharded_pre_downsample(pts, mask, tparams, tcaps, mesh)
        assert len(got[0]) == len(got[1]) == 2
        for a, b in zip((torch.cat(got[0]), torch.cat(got[1]), got[2]), whole):
            assert torch.equal(a, b)
        chunks += got[:2]
    split = tmesh.make_sharded_register_fn(tparams, tcaps, mesh)(*chunks)
    want = make_register_fn(tparams, tcaps, batched=True, device="cpu")(
        *(torch.cat(c) for c in chunks))
    for name, a, b in zip(split._fields, split, want):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="not in 2 chunks"):
        tmesh.make_sharded_register_fn(tparams, tcaps, mesh)(
            chunks[0][:1], *chunks[1:])


def test_split_matches_jax_sharded(params, caps, batch8, unsplit):
    """The JAX package's sharded program over its 8 virtual devices
    against the port split over [cpu] * 2."""
    args, _ = batch8
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    j = jmesh.make_sharded_register_fn(params, caps, jmesh.make_mesh())(*args)
    t = tmesh.make_sharded_register_fn(*_port(params, caps),
                                       tmesh.make_mesh(["cpu"] * 2))(*args)
    for b in range(8):
        assert_result_matches(type(t)(*(f[b] for f in t)),
                              type(j)(*(f[b] for f in j)))


def test_split_refuses_an_axis_it_does_not_divide(params, caps, batch8):
    args, _ = batch8
    fn = tmesh.make_sharded_register_fn(*_port(params, caps),
                                        tmesh.make_mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="does not divide"):
        fn(*args)


def test_sharded_mean_errors_match_jax(batch8, unsplit):
    """Against the port's own registration_errors over the whole batch
    (rtol 1e-6: float32 sums in chunks), and against the JAX package's
    psum over its 8 devices at tests/test_torch_sweep.py's RRE/RTE bands
    (atol 1e-2 deg / 1e-4 m: each package's float32 RRE of a near-identity
    error is an acos within ulps of 1)."""
    from fccf_pcr_torch import registration_errors

    _, gts = batch8
    T = unsplit.transform
    rre, rte = registration_errors(T, torch.as_tensor(gts, dtype=T.dtype))
    whole = [float(rre.mean()), float(rte.mean())]
    want = jmesh.sharded_mean_errors(T.numpy(), gts.astype(np.float32),
                                     jmesh.make_mesh())
    for k in (1, 2, 4):
        got = tmesh.sharded_mean_errors(T, gts, tmesh.make_mesh(["cpu"] * k))
        np.testing.assert_allclose(got, whole, rtol=1e-6)
        np.testing.assert_allclose(got[0], float(want[0]), atol=1e-2)
        np.testing.assert_allclose(got[1], float(want[1]), atol=1e-4)


def test_make_mesh_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py uses it")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tmesh.make_mesh(["cuda:0", "cuda:0"])


@pytest.mark.parametrize("batch_size, use_mesh", [(8, True), (3, True),
                                                  (8, False)])
def test_sweep_summary_reports_devices_as_jax(params, caps, batch_size,
                                              use_mesh, monkeypatch):
    """n_devices and sharded for 8 devices: the JAX package's from its 8
    virtual CPU devices, the port's from [cpu] * 8."""
    if len(jax.devices()) != 8:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    _, jsum = jsweep.run_sweep([], params, caps, batch_size=batch_size,
                               use_mesh=use_mesh)
    _cards(monkeypatch, 8)
    _, tsum = tsweep.run_sweep([], *_port(params, caps),
                               batch_size=batch_size, device="cpu",
                               use_mesh=use_mesh)
    for key in ("n_devices", "sharded"):
        assert tsum[key] == jsum[key], key


def test_sweep_split_records_equal_unsplit(params, caps, monkeypatch):
    """Three pairs at batch 4 (the last chunk padded) over [cpu] * 2,
    each chunk downsampled and registered on its own device: the records
    equal the unsplit sweep's, bit for bit."""
    pairs = []
    for s in (31, 32, 33):
        src, tar, _ = synthetic.make_pair(
            seed=s, points_per_plane=400, clutter_points=200,
            room=(8.0, 6.0, 3.0))
        pairs.append((src, tar))
    tparams, tcaps = _port(params, caps)
    whole, wsum = tsweep.run_sweep(pairs, tparams, tcaps, batch_size=4,
                                   device="cpu")
    _cards(monkeypatch, 2)
    split, ssum = tsweep.run_sweep(pairs, tparams, tcaps, batch_size=4,
                                   device="cpu")
    assert (ssum["n_devices"], ssum["sharded"]) == (2, True)
    assert (wsum["n_devices"], wsum["sharded"]) == (1, False)
    assert len(split) == 3
    for a, b in zip(split, whole):
        a, b = dict(a), dict(b)
        a.pop("batch_time_s"), b.pop("batch_time_s")
        assert a == b
