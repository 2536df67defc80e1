"""Served 3D volumes: a closed loop of one client with one volume in flight,
each a HU volume already in host memory handed to
``UNet3D.segment_volume(vol, window=...)`` (upload, HU window, the
configuration's net over the sliding window's patches, the Gaussian
blend, the threshold) until its {0, 255} mask is a host array."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.common import data, manifest
from portbench.common.readout import NET_RANGE
from portbench.common.weights import load_into
from portbench.reference import sliding_window as ref_sw
from portbench.reference.fp8 import quant_e4m3
from portbench.reference.train import exact_fp32

SAMPLE = 4  # served masks kept, a uniform sample drawn from the seed


def tiny(cell: dict, patch: int) -> None:
    """Cut ``cell`` for a CPU test, around the net's tiny patch edge
    ``patch``: three volumes of ``patch`` x 4 ``patch`` x 4 ``patch``, 32
    patches a call."""
    cell["config_data"]["inference"].update(patch_size=[patch] * 3, sw_batch_size=32)
    cell["traffic"].update(pool=3, volume_shape=[patch, 4 * patch, 4 * patch])


class _Annotated(torch.nn.Module):
    """The net inside the benchmark's span (traced runs only)."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x):
        with torch.profiler.record_function(NET_RANGE):
            return self.net(x)


class Driver:
    unit = "volumes"

    def __init__(self, cell: dict, seed: int, device):
        from ich_tpu_torch.train.segmentation3d import UNet3D

        self.cfg, self.traffic = cell["config_data"], cell["traffic"]
        self.seed, self.device = seed, torch.device(device)
        net_cfg, inf = self.cfg["net"], self.cfg["inference"]
        self.arch = manifest.net(net_cfg)  # nets/<arch>.py
        self.window_hu = tuple(self.cfg["data"]["window"])
        vols, _ = data.volumes_dhw(seed, self.traffic["pool"], self.traffic["volume_shape"],
                                   self.device)
        self.pool = [v.cpu().numpy() for v in vols]
        _, gen = data.generators(seed + 1, self.device)
        self.weights = self.arch.make_weights(net_cfg, gen, self.device)
        self.arch.calibrate_final_bias(self.weights, net_cfg, self._central_patches(vols[0]),
                                       train=False)
        del vols
        net = self.arch.build(net_cfg, self.device)
        load_into(net, self.weights)
        self.patch = tuple(inf["patch_size"])
        self.trainer = UNet3D(net, patch_size=self.patch, sw_overlap=inf["sw_overlap"],
                              sw_batch_size=inf["sw_batch_size"], device=self.device)
        self.rng = np.random.default_rng(seed + 2)
        self.order = self.rng.permutation(len(self.pool))
        for i in range(2):  # warm-up: every shape of the window
            self.serve(self.pool[self.order[i]])
        self.kept = []  # (request index, pool index, mask)

    def work(self) -> dict:
        """A volume's FLOPs: the net's forward over every patch of the
        sliding window's grid, from the shapes."""
        return {"flops": len(self._grid()) * self.arch.flops(self.cfg["net"], 1, self.patch,
                                                             train=False)}

    def _grid(self):
        d, h, w = self.traffic["volume_shape"]
        ov = self.cfg["inference"]["sw_overlap"]
        return [(a, b, c) for a in ref_sw.starts(d, self.patch[0], ov)
                for b in ref_sw.starts(h, self.patch[1], ov)
                for c in ref_sw.starts(w, self.patch[2], ov)]

    def _central_patches(self, vol: torch.Tensor) -> torch.Tensor:
        """Four central patches of a HU volume, windowed: (4, 1, p, p, p)."""
        p = self.cfg["inference"]["patch_size"][0]
        d, h, w = vol.shape
        x = ref_sw.window_ct(vol[:p, h // 2 - p:h // 2 + p, w // 2 - p:w // 2 + p],
                             *self.cfg["data"]["window"])
        return x.reshape(p, 2, p, 2, p).permute(1, 3, 0, 2, 4).reshape(4, 1, p, p, p)

    def serve(self, vol: np.ndarray) -> np.ndarray:
        return self.trainer.segment_volume(vol, window=self.window_hu)

    def annotate(self) -> None:
        self.trainer.unet = _Annotated(self.trainer.unet)

    def window(self, seconds: float) -> dict:
        lat, n = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k = int(self.order[n % len(self.order)])
            ts = time.perf_counter()
            mask = self.serve(self.pool[k])
            lat.append(time.perf_counter() - ts)
            # reservoir sampling: every served volume equally likely kept
            slot = n if n < SAMPLE else int(self.rng.integers(0, n + 1))
            if slot < SAMPLE:
                if slot == len(self.kept):
                    self.kept.append(None)
                self.kept[slot] = (n, k, mask)
            n += 1
        elapsed = time.perf_counter() - t0
        return {"units": n, "attempted": n, "failed": 0, "seconds": elapsed,
                "metrics": {"volumes_per_s": n / elapsed,
                            "volume_latency_p90_s": float(np.percentile(lat, 90))}}

    def free(self) -> None:
        del self.trainer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _probs(self, k: int, quant=None) -> torch.Tensor:
        net_cfg = self.cfg["net"]
        vol = torch.from_numpy(self.pool[k]).to(self.device)
        with exact_fp32():
            return ref_sw.probabilities(
                lambda x: self.arch.forward(self.weights, x, net_cfg, quant=quant), vol,
                self.patch, self.cfg["inference"]["sw_overlap"], self.window_hu)

    def _judge(self, served) -> dict:
        """``mask_margin``: the widest distance from the threshold of a
        reference probability whose voxel the served mask puts on the other
        side (0 where all agree); ``mask_mismatch``: the share of such
        voxels. ``served`` maps request index to (pool index, mask)."""
        ref = {k: self._probs(k) for k in sorted({k for k, _ in served.values()})}
        margin, mismatch = 0.0, 0.0
        for k, mask in served.values():
            p = ref[k]
            m = torch.from_numpy(np.asarray(mask)).to(self.device)
            if m.shape != p.shape or not bool(((m == 0) | (m == 255)).all()):
                return {"mask_margin": float("inf"), "mask_mismatch": 1.0}
            wrong = (m == 255) != (p >= 0.5)
            if wrong.any():
                margin = max(margin, float((p[wrong] - 0.5).abs().max()))
            mismatch = max(mismatch, float(wrong.float().mean()))
        return {"mask_margin": margin, "mask_mismatch": mismatch}

    def check(self, detail: bool = False) -> dict:
        return self._judge({n: (k, m) for n, k, m in self.kept})

    def control(self) -> dict:
        """The reference in fp8 in the program's place, on the same
        volumes."""
        served = {}
        for n, k, _ in self.kept:
            p = self._probs(k, quant=quant_e4m3)
            served[n] = (k, ((p >= 0.5).to(torch.uint8) * 255).cpu().numpy())
        return self._judge(served)
