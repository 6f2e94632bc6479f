"""Two-stage serving: `TwoStagePipeline.__call__` on a stream of requests of
raw frames, open loop at the mix's fixed rate (a camera's frames in groups
of `batch_size`): request k is due `k / rate_per_s` seconds into the
window and is handed over at its due time, or as soon as the one before
it is done; its frames, intrinsics and bone lengths go over as host
arrays, and its joints and crop boxes are read back to the host. A
request's latency runs from its due time to its joints on the host, so a
late start counts.

The requests cycle through a pool drawn from the seed, so every seed
serves the same number of the same sizes at the same times. Set-up builds
the detector and the pose net from the benchmark's weights and the
pipeline, and serves two requests (the first settles cuDNN). The check
runs the plain reference over a sample of the pool and compares every
time the port served those requests.
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

WARM_REQUESTS = 2


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault: str | None = None):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.fault = seed, torch.device(device), fault
        self.batch = traffic["batch_size"]
        self.pool = traffic["pool_requests"]

    def setup(self) -> None:
        from hand_integral_pose_estimation_tpu_torch import inference
        from hand_integral_pose_estimation_tpu_torch.detect import (
            FasterRCNN,
        )
        from hand_integral_pose_estimation_tpu_torch.models import get_pose_net

        self.inference = inference
        phases = self.phases = Phases()
        configure_precision(self.config["precision"])
        cfg = port_config(self.config, self.traffic)
        f = self.frames = frames_mod.render(
            self.pool * self.batch, 2 * self.seed + 1, self.device,
            image_hw=tuple(self.config["data"]["frame_hw"]))
        phases.mark("frames")
        self.pose_state = weights.pose_state(self.config, f, 2 * self.seed,
                                             self.device)
        self.det_state = weights.detector_state(self.config, f,
                                                2 * self.seed + 2, self.device)
        release_device()
        phases.mark("weights")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        pose = get_pose_net(cfg.model, torch.Generator().manual_seed(0))
        pose.load_state_dict(self.pose_state)
        det = FasterRCNN(cfg.detector)
        det.load_state_dict(self.det_state)
        self.pipeline = inference.TwoStagePipeline(cfg, pose, det,
                                                   device=self.device)
        if self.fault == "altered":
            run = self.pipeline._run

            def altered(*args):
                out = run(*args)
                return out._replace(joints_cam=out.joints_cam + 0.01)
            self.pipeline._run = altered
        elif self.fault is not None:
            raise ValueError(f"unknown fault {self.fault!r}")
        b = self.batch
        self.requests = [(f.images[i * b:(i + 1) * b], f.K[i * b:(i + 1) * b],
                          f.ref_bone_len[i * b:(i + 1) * b])
                         for i in range(self.pool)]
        rng = np.random.RandomState(self.seed % (1 << 32))
        self.sample = sorted(rng.choice(
            self.pool, min(self.pool, self.traffic["checked_requests"]),
            replace=False).tolist())
        self.served = {i: [] for i in self.sample}
        self.next = 0
        phases.mark("pipeline")
        for _ in range(WARM_REQUESTS):
            self._serve()
        phases.mark("warm requests")

    def _serve(self):
        """One request: (its index in the pool, [crop boxes, label-space
        coords, joints] on the host)."""
        i = self.next % self.pool
        self.next += 1
        out = self.pipeline(*self.requests[i])
        return i, [t.cpu().numpy() for t in (out.crop_bbox, out.coords_label,
                                             out.joints_cam)]

    def window(self, seconds: float, spans: bool = False) -> Window:
        events = []
        spans = spans and self.device.type == "cuda"
        if spans:
            detect = self.inference.detect_hand_crop_bbox

            def timed(*args, **kwargs):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = detect(*args, **kwargs)
                b.record()
                events.append((a, b))
                return out
            self.inference.detect_hand_crop_bbox = timed
        period = 1.0 / self.traffic["rate_per_s"]
        n = max(1, int(seconds / period))
        latencies, late, service, failed = [], [], [], 0
        try:
            start = time.perf_counter()
            for k in range(n):
                due = start + k * period
                while (now := time.perf_counter()) < due:
                    time.sleep(min(due - now, 1e-3))
                i, host = self._serve()
                done = time.perf_counter()
                latencies.append(1e3 * (done - due))
                late.append(1e3 * (now - due))
                service.append(1e3 * (done - now))
                failed += int(not all(np.isfinite(a).all() for a in host))
                if i in self.served:
                    self.served[i].append(host)
            elapsed = time.perf_counter() - start
        finally:
            if spans:
                self.inference.detect_hand_crop_bbox = detect
        return Window(seconds=elapsed, units=n, images=n * self.batch,
                      batches=n, batch=self.batch, failed=failed,
                      latencies_ms=latencies,
                      spans={"detect_ms": [a.elapsed_time(b)
                                           for a, b in events],
                             "late_ms": late, "service_ms": service})

    def release(self) -> None:
        del self.pipeline
        release_device()

    def reference_outputs(self, precision: str = "float32") -> dict:
        """The plain reference's [crop boxes, coords, joints] of each
        sampled request; `precision` is one for both nets or
        "detector,pose"."""
        from benchmark.reference import Precision
        from benchmark.reference.detector import Detector, two_stage
        from benchmark.reference.pose import PoseNet

        m = self.config["model"]
        pose = PoseNet(m["resnet_type"], m["num_joints"], m["depth_dim"],
                       m["deconv_channels"], m["num_deconv_layers"]).to(
                           self.device).eval()
        pose.load_state_dict(self.pose_state)
        det = Detector(self.config["detector"]).to(self.device).eval()
        det.load_state_dict(self.det_state)
        det_p, _, pose_p = precision.partition(",")
        out = {}
        for i in self.sample:
            images, K, ref = (torch.from_numpy(a).to(self.device)
                              for a in self.requests[i])
            got = two_stage(det, pose, images, K, ref, Precision(det_p),
                            Precision(pose_p or det_p), m["input_shape"][0])
            out[i] = [t.cpu().numpy() for t in got]
        del pose, det
        release_device()
        return out

    def back_projected(self, i: int, boxes, coords) -> np.ndarray:
        """The reference's last stage on the port's own crop boxes and
        coords of request `i`: the joints it should have returned."""
        from benchmark.reference.geometry import (
            label_to_camera,
            scale_by_ref_bone,
            tprime_from_bbox,
            trans_from_box,
        )

        _, K, ref = (torch.from_numpy(a) for a in self.requests[i])
        box, coords = torch.from_numpy(boxes), torch.from_numpy(coords)
        size = self.config["model"]["input_shape"][0]
        cam = label_to_camera(coords, trans_from_box(box, size, inv=True),
                              tprime_from_bbox(box, K), K, size)
        return scale_by_ref_bone(cam, ref).numpy()

    def numbers(self, served: dict, reference: dict,
                compared: bool = True) -> dict:
        """Over every time a sampled request was served:

        - `box_gap_px`: the widest gap of a crop box coordinate from the
          reference's, in pixels;
        - `coord_gap_max`, `coord_gap_median`: the widest and the median
          gap of a label-space coordinate (the patch's width is 1);
        - `joint_gap`: the widest gap of the returned joints from the
          reference's back-projection of the port's own boxes and coords,
          each frame's joints over their own norm.

        The joints are scaled to the reference bone by the predicted bone,
        one factor a frame, which a short predicted bone makes far more
        sensitive than the coords: it moves the sound port's joints from
        the back-projection of its own coords about as far as it moves
        the control's, so each frame's norm takes it out. With `compared`
        False also the readings that do not separate the port from the
        control (PERF.md): the widest and the median gap of the returned
        joints from the reference's own, over their norms
        (`joint_dir_gap_*`), and the factor's widest gap from the
        back-projection's (`joint_scale_gap`)."""
        box = joint = scale = 0.0
        coord, direction = [], []
        for i, outs in served.items():
            rb, rc, rj = reference[i]
            for b, c, j in outs:
                box = max(box, float(np.abs(b - rb).max()))
                coord.append(np.abs(c - rc))
                direction.append(np.abs(_unit(j) - _unit(rj)))
                want = self.back_projected(i, b, c)
                joint = max(joint, float(np.abs(_unit(j) - _unit(want))
                                         .max()))
                scale = max(scale, float(np.abs(
                    np.linalg.norm(j, axis=(1, 2))
                    / np.linalg.norm(want, axis=(1, 2)) - 1).max()))
        coord, direction = np.stack(coord), np.stack(direction)
        out = {"box_gap_px": box, "coord_gap_max": float(coord.max()),
               "coord_gap_median": float(np.median(coord)),
               "joint_gap": joint}
        if not compared:
            out["joint_dir_gap_max"] = float(direction.max())
            out["joint_dir_gap_median"] = float(np.median(direction))
            out["joint_scale_gap"] = scale
        return out

    def check(self) -> dict:
        return self.numbers(self.served, self.reference_outputs())

    def readings(self) -> dict:
        """The compared numbers and those that are not."""
        return self.numbers(self.served, self.reference_outputs(),
                            compared=False)

    def control(self, precision: str) -> dict:
        """The readings of the reference computed in `precision`, put in
        the program's place."""
        low = self.reference_outputs(precision)
        return self.numbers({i: [v] for i, v in low.items()},
                            self.reference_outputs(), compared=False)


def _unit(joints: np.ndarray) -> np.ndarray:
    """Each frame's joints over their norm."""
    return joints / np.linalg.norm(joints, axis=(1, 2), keepdims=True)
