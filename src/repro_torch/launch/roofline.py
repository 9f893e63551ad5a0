"""Roofline terms of a dry-run cell, the counterpart of the reference's
``launch/hlo_analysis.py`` (the same ``Roofline`` fields and ``row()``
keys), with the port's counter (``launch/op_cost.py``) in place of the
compiled HLO.

Hardware model: the datasheet NVIDIA H100 SXM5 80GB at 700 W, per card:
989.4 TFLOP/s dense bf16 (tensor cores), 3.35 TB/s HBM3, and two link
rates: 450 GB/s a direction over NVLink for a collective whose ranks lie
in one node of 8 cards, 50 GB/s (one 400 Gb/s NIC a card) for one that
spans nodes.  On the (16, 16) and (2, 16, 16) meshes every axis spans
nodes.  These are datasheet peaks, not measurements: a time from them is
a bound.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989.4e12        # dense bf16 / card
HBM_BW = 3.35e12             # bytes/s / card
NVLINK_BW = 450e9            # bytes/s / card, one direction, inside a node
NET_BW = 50e9                # bytes/s / card (a 400 Gb/s NIC), across nodes


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes moved
    coll_bytes: float            # per-device link bytes
    n_chips: int
    nvlink_bytes: float = 0.0    # the part of coll_bytes inside one node

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return ((self.coll_bytes - self.nvlink_bytes) / NET_BW
                + self.nvlink_bytes / NVLINK_BW)

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def row(self) -> dict:
        return dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                    coll_bytes=self.coll_bytes,
                    t_compute=self.t_compute, t_memory=self.t_memory,
                    t_collective=self.t_collective,
                    bottleneck=self.bottleneck)


def roofline_from_counter(counter, n_chips: int) -> Roofline:
    """The terms an :class:`~repro_torch.launch.op_cost.OpCost` counted
    (one rank's, trip-aware)."""
    return Roofline(flops=counter.flops, hbm_bytes=counter.hbm_bytes,
                    coll_bytes=counter.coll_bytes, n_chips=n_chips,
                    nvlink_bytes=counter.nvlink_bytes)
