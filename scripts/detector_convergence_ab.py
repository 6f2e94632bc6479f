"""The detector's convergence study in the JAX package and in the port, on
the CPU at one equal setting, with each known difference between the two
switched in turn.

Both packages' `cli/detector_convergence.run_study` train R18-C4 from
scratch (`DetectorConfig.native`) on the same synthetic scenes
(`detect/synthetic.py`, bitwise equal in both: tests/
test_torch_detector_native.py) and score held-out VOC AP. Their train steps
agree on the same weights and draws (tests/test_torch_detector_native.py,
the JAX proposals stop-gradiented). What differs:

- the initial weights of the five head layers (the RPN's 3x3 conv and its
  two 1x1 outputs, the class and box Linears): the JAX package leaves
  them at flax's default, LeCun normal (std 1/sqrt(fan_in): 0.021 for the
  RPN conv, 0.044 for the rest); the port draws them as the reference's
  `_init_weights` does, N(0, 0.01) and N(0, 0.001) for the box regressor;
- the JAX package differentiates the loss through the proposal boxes; the
  port, as the reference, detaches them;
- the random draws (weights, anchor and RoI subsampling).

Arms, one a process (`--arm`):

    jax             the JAX package's study as it is
    jax-ref-heads   the JAX study with its head layers re-drawn as the
                    port draws them
    jax-stopped     the JAX study with the proposals stop-gradiented
    torch           the port's study on the CPU
    torch-jax-init  the port's study from the JAX package's initial
                    weights at the same seed (carried by `interop`)

Each prints the study's JSON lines prefixed by the arm. Run from the repo
root, e.g. two arms on two cores each:

    JAX_PLATFORMS=cpu OMP_NUM_THREADS=2 taskset -c 0-1 python3 \\
        scripts/detector_convergence_ab.py --arm jax
    JAX_PLATFORMS=cpu OMP_NUM_THREADS=2 taskset -c 2-3 python3 \\
        scripts/detector_convergence_ab.py --arm torch

Every arm runs one setting, the record's (224 px, batch 8, SGD 2e-3,
flip) cut to CPU size: 128 train / 32 val scenes, 200 steps (the rate cut
by 0.3 at step 100), an evaluation every 25, seed 0.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETTING = dict(train_n=128, val_n=32, hw=(224, 224), steps=200, batch=8,
               eval_every=25, lr=2e-3, seed=0)

# the head layers whose initial weights differ: the JAX package's names,
# and the std the port draws each with
REF_HEAD_STD = {"rpn_conv": 0.01, "rpn_cls": 0.01, "rpn_bbox": 0.01,
                "cls_score": 0.01, "bbox_pred": 0.001}


def jax_init_state():
    """The JAX study's initial train state at SETTING (as its run_study
    makes it)."""
    import jax

    from hand_integral_pose_estimation_tpu.cli.detector_convergence import (
        study_config,
    )
    from hand_integral_pose_estimation_tpu.detect.faster_rcnn import (
        FasterRCNN,
    )
    from hand_integral_pose_estimation_tpu.training import detector_trainer

    hw = SETTING["hw"]
    tx = detector_trainer.make_detector_optimizer(
        lr=SETTING["lr"], decay_step=SETTING["steps"] // 2,
        decay_factor=0.3)
    state, _ = detector_trainer.create_detector_train_state(
        FasterRCNN(cfg=study_config(hw)),
        jax.random.PRNGKey(SETTING["seed"]), sample_hw=hw, tx=tx)
    return state


def run_jax(arm, log):
    import jax
    import jax.numpy as jnp

    from hand_integral_pose_estimation_tpu.cli import detector_convergence
    from hand_integral_pose_estimation_tpu.detect import faster_rcnn
    from hand_integral_pose_estimation_tpu.training import detector_trainer

    if arm == "jax-stopped":
        orig = faster_rcnn.proposal_layer
        faster_rcnn.proposal_layer = lambda *a, **k: jax.tree_util.tree_map(
            jax.lax.stop_gradient, orig(*a, **k))
    if arm == "jax-ref-heads":
        orig_state = detector_trainer.create_detector_train_state

        def with_ref_heads(model, rng, *a, **k):
            state, tx = orig_state(model, rng, *a, **k)
            params = dict(state.params)
            key = jax.random.fold_in(rng, 2)
            for i, (name, std) in enumerate(sorted(REF_HEAD_STD.items())):
                kernel = params[name]["kernel"]
                params[name] = {
                    "kernel": std * jax.random.normal(
                        jax.random.fold_in(key, i), kernel.shape,
                        kernel.dtype),
                    "bias": jnp.zeros_like(params[name]["bias"])}
            return state._replace(params=params), tx

        detector_trainer.create_detector_train_state = with_ref_heads
    return detector_convergence.run_study(**SETTING, log=log)


def run_torch(arm, log):
    from hand_integral_pose_estimation_tpu_torch import detect
    from hand_integral_pose_estimation_tpu_torch.cli import (
        detector_convergence,
    )

    if arm == "torch-jax-init":
        from hand_integral_pose_estimation_tpu_torch.interop import (
            detector_state_dict_from_jax,
        )
        real = detect.build_detector
        state = jax_init_state()

        def from_jax(cfg, *a, **k):
            model = real(cfg, *a, **k)
            model.load_state_dict(detector_state_dict_from_jax(
                {"params": state.params, "batch_stats": state.batch_stats},
                cfg))
            return model

        detect.build_detector = from_jax
    return detector_convergence.run_study(**SETTING, device="cpu", log=log)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arm", required=True,
                   choices=("jax", "jax-ref-heads", "jax-stopped", "torch",
                            "torch-jax-init"))
    args = p.parse_args()

    def log(line):
        print(f"[{args.arm}] {line}", flush=True)

    log(json.dumps(SETTING))
    run = run_jax if args.arm.startswith("jax") else run_torch
    result = run(args.arm, log)
    log(json.dumps({"final_ap": result["final_ap"],
                    "history": [(h["step"], h["ap"]) for h in
                                result["history"]]}))


if __name__ == "__main__":
    main()
