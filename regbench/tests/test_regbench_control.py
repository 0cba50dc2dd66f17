"""The precision control on the card: the reference computed with its
matrix products in TF32 (the precision below the configuration's float32
with TF32 off), put in the program's place, is not correct by the
configuration's limits on every seed whose pool it registers otherwise
than the reference does; the program on the same pairs is correct. At
each cell's own pool, on three seeds: on some pools no TF32 product
changes a decision, and the control computes what the reference does."""

import pytest
import torch

import _paths
import run
from benchlib import compare, loop, pool as pool_mod, spec

SEEDS = (3000000013, 3000000014, 3000000015)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import fccf_pcr_torch as port

    run.build_kernels(port)
    return torch.device("cuda", 0), port


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.manifest(_paths.ROOT)["workloads"]])
def test_control_fails_program_passes(card, cell):
    device, port = card
    c = spec.cell(cell)
    limits = c.config["limits"]
    differing = 0
    for seed in SEEDS:
        pool = pool_mod.make_pool(c.config, c.traffic, seed, pin=True)
        runner = loop.Runner(port, c.config, pool, device)
        for slot in range(len(pool.batches)):
            runner.run(slot)
        prog = run.program_outputs(runner)
        del runner
        ref = run.reference_outputs(pool, c.config, device)
        ctl = run.numbers(run.reference_outputs(pool, c.config, device,
                                                control="tf32"), ref)
        assert compare.verdict(run.numbers(prog, ref), limits)[0], seed
        if any(ctl.values()):
            differing += 1
            assert not compare.verdict(ctl, limits)[0], (seed, ctl)
    assert differing, "TF32 changed nothing on any seed"
