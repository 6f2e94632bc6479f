"""The evaluation sweep: `Tester.run(batch_size)` over a split of rendered
frames with boxes from the ground truth, as the test CLI runs it: the
batches dispatched ahead as CUDA-graph replays, one synchronisation a
sweep when the coordinates come to the host.

Set-up builds the Tester over the benchmark's weights and runs one sweep,
which warms the one batch shape (the eager call, the capture). The window
repeats whole sweeps until its time is up; a sweep's images are the
split's frames, without the padding rows of its last batch. The check runs
the plain reference over a sample of the split drawn from the seed and
compares every sweep's coordinates of those frames.
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
    port_config,
    release_device,
)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault: str | None = None):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.fault = seed, torch.device(device), fault
        self.batch = traffic["batch_size"]

    def setup(self) -> None:
        from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
        from hand_integral_pose_estimation_tpu_torch.training import Tester

        phases = self.phases = Phases()
        configure_precision(self.config["precision"])
        cfg = port_config(self.config, self.traffic)
        self.frames = frames_mod.render(self.config["data"]["testing_size"],
                                        2 * self.seed + 1, self.device)
        phases.mark("frames")
        self.state = weights.pose_state(self.config, self.frames,
                                        2 * self.seed, self.device)
        release_device()
        phases.mark("weights")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        model = get_pose_net(cfg.model, torch.Generator().manual_seed(0))
        model.load_state_dict(self.state)
        self.tester = Tester(cfg, frames_mod.PoolDataset(self.frames), model,
                             device=self.device,
                             fuse_head=self.config["fuse_head"])
        self.tester.dataset.record = False
        if self.fault == "altered":
            step = self.tester.eval_step

            def altered(batch):
                coords, loss = step(batch)
                return coords + 0.5 * (torch.arange(
                    coords.shape[0], device=coords.device) == 0)[:, None,
                                                                 None], loss
            self.tester.eval_step = altered
        elif self.fault is not None:
            raise ValueError(f"unknown fault {self.fault!r}")
        n = len(self.frames)
        rng = np.random.RandomState(self.seed % (1 << 32))
        self.sample = np.sort(rng.choice(
            n, min(n, self.traffic["checked_rows"]), replace=False))
        self.swept = []
        phases.mark("tester")
        self._sweep()
        phases.mark("warm sweep")

    def _sweep(self) -> np.ndarray:
        coords, _ = self.tester.run(batch_size=self.batch)
        return coords

    def window(self, seconds: float, spans: bool = False) -> Window:
        n = len(self.frames)
        sweeps = failed = 0
        start = time.perf_counter()
        while not sweeps or time.perf_counter() - start < seconds:
            coords = self._sweep()
            sweeps += 1
            failed += int((~np.isfinite(coords).all(axis=(1, 2))).sum())
            self.swept.append(coords[self.sample])
        elapsed = time.perf_counter() - start
        return Window(seconds=elapsed, units=sweeps * n, images=sweeps * n,
                      batches=sweeps * -(-n // self.batch), batch=self.batch,
                      failed=failed)

    def release(self) -> None:
        del self.tester
        release_device()

    def reference_coords(self, precision: str = "float32",
                         block: int = 64) -> np.ndarray:
        """The plain reference's coordinates of the sampled frames."""
        from benchmark.reference import Precision
        from benchmark.reference.pose import PoseNet, eval_batch

        m = self.config["model"]
        net = PoseNet(m["resnet_type"], m["num_joints"], m["depth_dim"],
                      m["deconv_channels"], m["num_deconv_layers"]).to(
                          self.device)
        net.load_state_dict(self.state)
        net.eval()
        q = Precision(precision)
        f = self.frames
        out = []
        with torch.no_grad(), q:
            for i in range(0, len(self.sample), block):
                rows = self.sample[i:i + block]

                def dev(a):
                    return torch.from_numpy(a[rows]).to(self.device)

                patch, _ = eval_batch(dev(f.images), dev(f.joint_cam),
                                      dev(f.K), size=m["input_shape"][0])
                out.append(net(patch, q).cpu().numpy())
        del net
        release_device()
        return np.concatenate(out)

    def numbers(self, swept, reference) -> dict:
        """The widest gap of any sampled coordinate of any sweep from the
        reference's, and the median gap, in label units (the patch's width
        is 1): the widest judges every answer, the median the precision."""
        gaps = np.abs(np.stack(swept) - reference)
        return {"coord_gap_max": float(gaps.max()),
                "coord_gap_median": float(np.median(gaps))}

    def check(self) -> dict:
        return self.numbers(self.swept, self.reference_coords())

    def control(self, precision: str) -> dict:
        """The numbers of the reference computed in `precision`, put in the
        program's place."""
        return self.numbers([self.reference_coords(precision)],
                            self.reference_coords())
