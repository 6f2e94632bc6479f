"""The training entry: `Trainer(scan_steps=1, fuse_head=True).run_epoch`, the
training CLI's own path (one CUDA-graph replay and one synchronisation a
step), over a pool of rendered frames.

Set-up builds the Trainer, loads the benchmark's weights, and runs the
eager warm-up and the capture of the step's graph; then it puts the
weights, the norms' statistics and Adam's state back as they were loaded,
in place, and drives the Trainer through its first `checked_steps` steps,
each its own `run_epoch` call of one step and each a replay of the graph
the window runs, reading the first step's gradient from Adam's state and
each leaf's change after the last; then it runs enough steps for the
Trainer's timers to leave their warm-up. The window runs `run_epoch` in calls of `chunk` steps until its
time is up. The check trains the plain reference from the same weights
over the same rows and augmentation draws, and compares each step's loss,
the first gradient and the change, leaf by leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import frames as frames_mod
from benchmark import weights
from benchmark.drivers import (
    Phases,
    Window,
    configure_precision,
    leaf_gap,
    norms,
    port_config,
    relative_gap,
    release_device,
)
from benchmark.reference.pose import running_stats

#: Trainer seeds stay below this: it seeds numpy's 32-bit generator with
#: seed * 100003 + epoch
TRAINER_SEEDS = 42000
#: the Trainer's timers leave out their first 10 calls
TIMER_WARMUP = 10
#: calls of one step that warm up and capture the step's graph
CAPTURE_STEPS = 2
#: kernel 4's own leaves: it writes their gradients
HEAD_LEAVES = ("head.final_layer.weight", "head.final_layer.bias")
#: leaves whose first reference gradient is below this share of the median
#: leaf's move by round-off alone under Adam, and count for no change
GRAD_FLOOR = 1e-3


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault: str | None = None):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.fault = seed, torch.device(device), fault
        self.batch = traffic["batch_size"]
        self.checked = traffic["checked_steps"]
        self.chunk = traffic["chunk"]
        self.trainer_seed = seed % TRAINER_SEEDS

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from hand_integral_pose_estimation_tpu_torch.training import Trainer

        phases = self.phases = Phases()
        configure_precision(self.config["precision"])
        cfg = port_config(self.config, self.traffic)
        data = self.config["data"]
        self.frames = frames_mod.render(
            data["training_size"], 2 * self.seed + 1, self.device)
        phases.mark("frames")
        self.state = weights.pose_state(self.config, self.frames,
                                        2 * self.seed, self.device)
        release_device()
        phases.mark("weights")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.dataset = frames_mod.PoolDataset(self.frames)
        t = self.trainer = Trainer(
            cfg, self.dataset, device=self.device, seed=self.trainer_seed,
            scan_steps=1, fuse_head=self.config["fuse_head"],
            model_dir="output/benchmark_unused")
        t.model.load_state_dict(self.state)
        self._plant(t)
        phases.mark("trainer")
        for epoch in range(CAPTURE_STEPS):
            self._epoch(epoch, 1)
        self._restart()
        phases.mark("capture")
        self.losses = []
        beta1 = t.optimizer.param_groups[0]["betas"][0]
        names = {p: n for n, p in t.model.named_parameters()}
        for epoch in range(self.checked):
            self.losses.append(self._epoch(epoch, 1)["loss"])
            if epoch == 0:
                self.first_grad = {names[p]: (s["exp_avg"] / (1 - beta1)).cpu()
                                   for p, s in t.optimizer.state.items()}
                self.stats = {k: v.cpu() for k, v in
                              running_stats(t.model).items()}
        self.change = norms({n: p.detach() - self.state[n]
                             for n, p in t.model.named_parameters()})
        phases.mark("checked steps")
        self.rows = [np.array(r) for r in self.dataset.served[:self.checked]]
        self.dataset.record = False
        self.epoch = self.checked
        warm = max(1, TIMER_WARMUP + 1 - CAPTURE_STEPS - self.checked)
        self._epoch(self.epoch, warm)
        self.epoch += 1
        phases.mark("warm steps")

    def _epoch(self, epoch: int, steps: int) -> dict:
        return self.trainer.run_epoch(epoch, num_steps=steps,
                                      log_every=1 << 30)

    def _restart(self) -> None:
        """The loaded weights and norm statistics, Adam's zero state and
        the schedule's first rate, written in place into the tensors the
        captured graph reads, and no rows served yet."""
        t = self.trainer
        with torch.no_grad():
            t.model.load_state_dict(self.state)
            for state in t.optimizer.state.values():
                for v in state.values():
                    v.zero_()
        t.scheduler.step()
        t.global_step = 0
        self.dataset.served.clear()

    def _plant(self, t) -> None:
        """A fault in the timed path, for the checks' own tests: the
        optimizer's step left out (the state comes back unchanged), the
        step taken on the first half of each batch alone, or kernel 4's
        gradients of the projection scaled by 1.25 where they enter
        autograd."""
        if self.fault is None:
            return
        if self.fault == "unchanged":
            t.optimizer.step = lambda *a, **k: None
        elif self.fault == "half_batch":
            step = t.train_step
            t.train_step = lambda b: step(type(b)(*[
                v[:len(v) // 2] if torch.is_tensor(v) else v for v in b]))
        elif self.fault == "head_grad":
            for name, p in t.model.named_parameters():
                if name in HEAD_LEAVES:
                    p.register_hook(lambda g: g * 1.25)
        else:
            raise ValueError(f"unknown fault {self.fault!r}")

    # ------------------------------------------------------------ window
    def window(self, seconds: float, spans: bool = False) -> Window:
        t = self.trainer
        read0 = t.read_timer.total_time
        steps = failed = 0
        start = time.perf_counter()
        while not steps or time.perf_counter() - start < seconds:
            last = self._epoch(self.epoch, self.chunk)
            self.epoch += 1
            steps += self.chunk
            if not np.isfinite(last["loss"]):
                failed += self.chunk
        elapsed = time.perf_counter() - start
        return Window(seconds=elapsed, units=steps, images=steps * self.batch,
                      batches=steps, batch=self.batch, failed=failed, read_s=t.read_timer.total_time - read0)

    def release(self) -> None:
        del self.trainer
        release_device()

    # ------------------------------------------------------------ check
    def reference_steps(self, precision: str = "float32"):
        """The plain reference trained from the benchmark's weights over the
        checked steps' rows and draws: (losses, first gradient norms,
        change norms) by leaf."""
        from benchmark.reference import Precision
        from benchmark.reference.geometry import augmentation_draws
        from benchmark.reference.pose import PoseNet, train_steps

        m = self.config["model"]
        net = PoseNet(m["resnet_type"], m["num_joints"], m["depth_dim"],
                      m["deconv_channels"], m["num_deconv_layers"]).to(
                          self.device)
        net.load_state_dict(self.state)
        f = self.frames
        steps = []
        for epoch, rows in enumerate(self.rows):
            g = torch.Generator(device=self.device).manual_seed(
                self.trainer_seed * 131 + epoch)
            R, colour = augmentation_draws(g, len(rows))

            def dev(a):
                return torch.from_numpy(a[rows]).to(self.device)

            steps.append({"image": dev(f.images), "joint_cam": dev(f.joint_cam),
                          "K": dev(f.K), "labelled": dev(f.labelled),
                          "R": R, "colour": colour})
        tr = self.config["train"]
        losses, first, change, stats = train_steps(
            net, steps, tr["lr"], tr["weight_decay"], Precision(precision),
            size=m["input_shape"][0])
        out = (losses, {k: v.cpu() for k, v in first.items()}, norms(change),
               {k: v.cpu() for k, v in stats.items()})
        del net, steps, first, change, stats
        release_device()
        return out

    def numbers(self, program, reference, compared: bool = True) -> dict:
        """The compared numbers of a run (`program`: losses, first
        gradients by leaf, change norms by leaf, the norms' running
        statistics after the first step) against the reference's:

        - `stats_error_median`: the first step's update of each norm's
          running statistics (its batch statistics, the forward's), the
          norm of its difference from the reference's over the reference's,
          median over the norms;
        - `grad_gap_median`: the median leaf's gap between the norms of the
          first gradient, over the reference's norm or the median leaf's;
        - `head_channel_gap_median`: kernel 4's gradient of the
          projection, the gap between the norms of each output channel's
          weight row and bias, over the reference's norm or the median
          channel's, median over the channels (the L1 loss's sign, which
          rounding flips for the few coordinates nearest their labels,
          moves a few joints' channels and with them the whole leaf's
          norm by percents: PERF.md);
        - `change_gap`: the worst moving leaf's gap between the norms of
          the change after the steps.

        With `compared` False also the readings that cannot tell bf16
        from a lower precision on these random weights (PERF.md): every
        step's loss gap, the first step's, the worst leaf's gradient-norm
        gap, and the median leaf's gradient error (the norm of the
        difference); and the worse of kernel 4's two leaves' (the
        projection's weight and bias) gradient-norm gaps, over the
        reference's norm or the median leaf's (`head_grad_gap`)."""
        losses, first, change, stats = program
        r_losses, r_first, r_change, r_stats = reference
        r_norms, p_norms = norms(r_first), norms(first)
        median = float(np.median(list(r_norms.values())))
        moving = {k for k, v in r_norms.items() if v >= GRAD_FLOOR * median}
        start = self.state
        # a leaf the optimizer never stepped has no first gradient: 0
        p_rows = _channel_norms({k: first.get(k, torch.zeros_like(r_first[k]))
                                 for k in HEAD_LEAVES})
        r_rows = _channel_norms(r_first)
        update = {k: float(torch.linalg.vector_norm(
            (stats[k] - r_stats[k]).double())
            / torch.linalg.vector_norm((r_stats[k] - 0.9 * start[k].cpu())
                                       .double()).clamp_min(1e-30))
            for k in r_stats}
        out = {
            "stats_error_median": float(np.median(list(update.values()))),
            "grad_gap_median": leaf_gap(p_norms, r_norms, reduce=np.median),
            "head_channel_gap_median": float(np.median(
                np.abs(p_rows - r_rows)
                / np.maximum(r_rows, np.median(r_rows)))),
            "change_gap": leaf_gap(change, r_change, keep=moving),
        }
        if not compared:
            zero = torch.zeros(())
            diff = norms({k: first.get(k, zero) - v
                          for k, v in r_first.items()})
            out["loss_gap_first"] = relative_gap(losses[0], r_losses[0])
            out["loss_gap"] = max(relative_gap(a, b)
                                  for a, b in zip(losses, r_losses))
            out["grad_gap"] = leaf_gap(p_norms, r_norms)
            out["grad_error_median"] = float(np.median([
                diff[k] / max(r_norms[k], median) for k in r_norms]))
            out["head_grad_gap"] = leaf_gap(p_norms, r_norms,
                                            keep=HEAD_LEAVES, floor=median)
        return out

    def check(self) -> dict:
        return self.numbers(self._program(), self.reference_steps())

    def readings(self) -> dict:
        """The compared numbers and those they stand in for."""
        return self.numbers(self._program(), self.reference_steps(),
                            compared=False)

    def _program(self):
        return self.losses, self.first_grad, self.change, self.stats

    def control(self, precision: str) -> dict:
        """The readings of the reference computed in `precision`, put in
        the program's place."""
        return self.numbers(self.reference_steps(precision),
                            self.reference_steps(), compared=False)


def _channel_norms(grads: dict) -> np.ndarray:
    """The norm of each output channel's gradient of the projection: its
    weight row and its bias."""
    weight, bias = (grads[k].double() for k in HEAD_LEAVES)
    rows = torch.cat([weight.reshape(len(bias), -1), bias[:, None]], 1)
    return torch.linalg.vector_norm(rows, dim=1).numpy()
