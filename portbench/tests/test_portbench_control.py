"""The control, the reference put in the program's place in the precision
below the configuration's, comes out not correct: fp8 for the bf16 LSeg
(on the CPU at tiny shapes), TF32 for the f32 CLIP towers (TF32 exists
only on the card: there at each cell's own size)."""

import pytest
import torch

import portbench.run as R
from portbench.bench import registry
from conftest import tiny_cell


def readings(wl, seed, device, over=None, seconds=0.3):
    ctx = R.context(wl, seed, seconds, device, over)
    drv = registry.driver(wl["driver"])
    with torch.no_grad():
        st = drv.setup(ctx)
        drv.window(st, ctx)
        drv.free(st)
        ref = drv.reference(st, ctx)
        prog = drv.numbers(drv.outputs(st, ctx), ref, ctx, st)
        ctl = drv.numbers(drv.reference(st, ctx, drv.CONTROL), ref, ctx, st)
    return prog, ctl


def fails(nums, limits) -> bool:
    return any(nums[k] > v for k, v in limits.items())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_fails_the_build(seed):
    wl, over = tiny_cell("lseg-vitl16.build.packed")
    prog, ctl = readings(wl, seed, "cpu", over)
    assert not fails(prog, wl["limits"]) and fails(ctl, wl["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  registry.manifest()["workloads"]])
def test_control_fails_on_the_card(name, card):
    wl = registry.workload(name)
    for seed in (101, 102, 103):
        prog, ctl = readings(wl, seed, card, seconds=2.0)
        assert not fails(prog, wl["limits"]), (seed, prog)
        assert fails(ctl, wl["limits"]), (seed, ctl)
