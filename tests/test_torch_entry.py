"""The port's entry points (`hand_integral_pose_estimation_tpu_torch.entry`)
against their JAX twins in `__graft_entry__.py`, on the CPU."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from hand_integral_pose_estimation_tpu_torch.entry import (
    dryrun_multichip,
    entry,
)
from hand_integral_pose_estimation_tpu_torch.interop import (
    pose_state_dict_from_jax,
)


def test_entry_matches_jax():
    """`entry(device="cpu")`'s step on the JAX entry's R50 weights (carried
    across by the weight bridge) gives the JAX step's coords within 1e-4,
    on seeded images and on the example's zero images."""
    jax_fn, (params, batch_stats, x) = jax_entry.entry()
    fn, (model, example) = entry(device="cpu")
    assert tuple(example.shape) == x.shape == (8, 224, 224, 3)
    model.load_state_dict(pose_state_dict_from_jax(
        {"params": params, "batch_stats": batch_stats}))
    images = np.random.RandomState(0).uniform(
        0, 1, (2, 224, 224, 3)).astype(np.float32)
    images = np.concatenate([images, np.zeros_like(images[:1])])
    want = np.asarray(jax.jit(jax_fn)(params, batch_stats, images))
    got = fn(model, torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (3, 21, 3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_dryrun_multichip_two_ranks():
    """Both arms over two gloo ranks on the CPU: J = 21 on the whole
    projection and J = 20 with the projection split over model=2; no
    hand-written kernel launches off the card."""
    out = dryrun_multichip(2, device="cpu").splitlines()
    assert len(out) == 2
    assert out[0].startswith("dryrun_multichip(2): mesh {'data': 1, "
                             "'model': 2} J=21 ")
    assert out[0].endswith("data-parallel fallback (replicated weights)")
    assert " J=20 " in out[1] and out[1].endswith(
        "model-sharded (projection consumed in place)")
    for line in out:
        fields = dict(f.split("=") for f in line.split()
                      if f.startswith(("loss=", "eval_pa_mpjpe=")))
        assert all(np.isfinite(float(v)) for v in fields.values())
        assert " launches=none " in line


def test_dryrun_multichip_refuses_a_missing_card(monkeypatch):
    """Asked for the card where CUDA is missing, the dry run raises and
    starts no rank; it never falls back to the CPU."""
    from hand_integral_pose_estimation_tpu_torch import parallel

    def no_spawn(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(parallel, "spawn_ranks", no_spawn)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        dryrun_multichip(2)


@pytest.mark.parametrize("code, timeout, error", [
    ("print('rank', os.environ['RANK'], 'of', os.environ['WORLD_SIZE'])",
     60, None),
    ("print('rank', os.environ['RANK']); "
     "sys.exit(3 if os.environ['RANK'] == '1' else 0)", 60,
     r"ranks \[1\] of 2 failed\n--- rank 1\nrank 1"),
    ("import time; print('rank', os.environ['RANK'], flush=True); "
     "time.sleep(0 if os.environ['RANK'] == '0' else 60)", 2,
     r"ranks \[1\] of 2 failed \(the group outlived 2 s\)\n--- rank 1\n"
     r"rank 1"),
])
def test_spawn_ranks(tmp_path, code, timeout, error):
    """`parallel.spawn_ranks` gives each rank torchrun's environment and
    returns each rank's output; a rank that fails, or outlives the
    timeout (and is killed), raises with its output's tail."""
    import sys

    from hand_integral_pose_estimation_tpu_torch.parallel import spawn_ranks

    cmd = [sys.executable, "-c", "import os, sys; " + code]
    if error is None:
        logs = spawn_ranks(cmd, 2, cwd=str(tmp_path), timeout=timeout)
        assert logs == ["rank 0 of 2\n", "rank 1 of 2\n"]
    else:
        with pytest.raises(RuntimeError, match=error):
            spawn_ranks(cmd, 2, cwd=str(tmp_path), timeout=timeout)
