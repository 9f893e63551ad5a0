"""Fault tolerance for 1000+-node fleets: heartbeats, straggler detection,
and elastic re-mesh planning.

On real multi-host deployments these hooks sit in the launcher process; the
mechanisms are host-side and hardware-agnostic, so they are fully
exercisable (and unit-tested) in this container:

  - HeartbeatMonitor: hosts report per-step heartbeats; a host missing
    ``timeout_s`` is declared dead -> the runner snapshots (checkpoint is
    already step-atomic) and requests an elastic restart.
  - StragglerDetector: robust z-score over per-host step wall-times
    (median/MAD); persistent stragglers are flagged for replacement —
    the usual mitigation in a synchronous data-parallel fleet, where a
    slow host throttles every collective.
  - plan_elastic_mesh: given the surviving host count, pick the largest
    mesh (pods × data × model) that preserves the model axis (TP degree is
    a property of the checkpointed sharding; data/pod axes shrink freely).

Host Python with no device code: the port's own copy of
``repro/distributed/fault_tolerance.py``.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class HostState:
    last_beat: float | None = None
    step: int = -1
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 clock=time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.hosts = {h: HostState() for h in range(n_hosts)}

    def beat(self, host: int, step: int):
        st = self.hosts[host]
        st.last_beat = self.clock()
        st.step = step
        st.alive = True

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        dead = []
        for h, st in self.hosts.items():
            if st.last_beat is not None and now - st.last_beat > self.timeout_s:
                st.alive = False
                dead.append(h)
        return dead

    def all_alive(self) -> bool:
        return not self.dead_hosts()


class StragglerDetector:
    """Flag hosts whose step time is a robust outlier for >= ``patience``
    consecutive steps (median + k·MAD rule)."""

    def __init__(self, n_hosts: int, k: float = 4.0, patience: int = 3):
        self.k = k
        self.patience = patience
        self.strikes = [0] * n_hosts

    def observe(self, step_times: list[float]) -> list[int]:
        xs = sorted(step_times)
        n = len(xs)
        med = xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
        mad = sorted(abs(x - med) for x in xs)[n // 2] or 1e-9
        flagged = []
        for h, t in enumerate(step_times):
            if (t - med) / (1.4826 * mad) > self.k:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.patience:
                flagged.append(h)
        return flagged


def plan_elastic_mesh(n_hosts_alive: int, chips_per_host: int,
                      model_parallel: int,
                      pod_size_chips: int = 256) -> dict:
    """Largest (pod, data, model) mesh on the surviving chips, preserving
    the checkpoint's TP degree.  Returns axis sizes + dropped-chip count."""
    chips = n_hosts_alive * chips_per_host
    if chips < model_parallel:
        raise ValueError("not enough chips to preserve the model axis")
    data = chips // model_parallel
    pods = max(1, chips // pod_size_chips)
    while data % pods != 0 and pods > 1:
        pods -= 1
    used = data * model_parallel
    return {"pod": pods, "data": data // pods, "model": model_parallel,
            "chips_used": used, "chips_idle": chips - used}
