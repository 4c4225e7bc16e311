"""Elastic training runtime: failure handling, re-meshing, and group-bounded
commit scheduling (ZapRAID's §3.2 insight applied to distributed training).

Components:

* ``RankTable`` / ``ElasticRuntime`` -- heartbeat bookkeeping; on failure it
  plans the largest viable (data x model) mesh from surviving hosts, and the
  driver restores from the ZapRAID checkpoint (degraded restore if the lost
  host held a storage lane) and re-jits on the new mesh.  State resharding
  is free under GSPMD: global arrays are simply re-sharded by the new mesh.

* ``GroupCommitScheduler`` -- the paper's stripe-group idea applied to
  gradient commits: instead of a hard barrier every step (Zone-Write-like,
  one outstanding step), workers may run ahead within a *commit group* of G
  steps and complete out of order; a barrier lands only at group boundaries,
  and bounded metadata (G-entry commit table per group, the CST analogue)
  tracks which worker finished which step.  ``simulate`` quantifies the
  straggler-stall reduction under heavy-tailed per-step latencies -- the
  training-side reproduction of Figure 8's G-sweep.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


# --------------------------------------------------------------------- ranks

@dataclasses.dataclass
class RankInfo:
    rank: int
    healthy: bool = True
    last_heartbeat: float = 0.0


class RankTable:
    def __init__(self, n_ranks: int):
        self.ranks = {r: RankInfo(r) for r in range(n_ranks)}

    def heartbeat(self, rank: int, now: float) -> None:
        self.ranks[rank].last_heartbeat = now
        self.ranks[rank].healthy = True

    def sweep(self, now: float, timeout: float) -> list[int]:
        dead = []
        for r, info in self.ranks.items():
            if info.healthy and now - info.last_heartbeat > timeout:
                info.healthy = False
                dead.append(r)
        return dead

    def healthy(self) -> list[int]:
        return [r for r, i in self.ranks.items() if i.healthy]


class ElasticRuntime:
    """Plans mesh changes as hosts fail/join."""

    def __init__(self, n_hosts: int, chips_per_host: int, model_parallel: int,
                 heartbeat_timeout: float = 30.0):
        self.table = RankTable(n_hosts)
        self.chips_per_host = chips_per_host
        self.model_parallel = model_parallel
        self.timeout = heartbeat_timeout
        self.generation = 0

    def plan_mesh(self) -> tuple[int, int]:
        """Largest (data, model) mesh from healthy hosts.  The model axis is
        fixed (weights are TP-sharded); the data axis shrinks to the largest
        power-of-two of remaining chips."""
        chips = len(self.table.healthy()) * self.chips_per_host
        data = chips // self.model_parallel
        data_pow2 = 1 << max(0, (data.bit_length() - 1))
        return (data_pow2, self.model_parallel)

    def on_failure(self, dead_ranks: list[int]) -> dict:
        for r in dead_ranks:
            self.table.ranks[r].healthy = False
        self.generation += 1
        data, model = self.plan_mesh()
        return {
            "generation": self.generation,
            "mesh": (data, model),
            "healthy_hosts": len(self.table.healthy()),
            "action": "restore_from_checkpoint_and_rejit",
        }

    def on_join(self, rank: int) -> dict:
        self.table.ranks[rank] = RankInfo(rank, healthy=True)
        self.generation += 1
        data, model = self.plan_mesh()
        return {"generation": self.generation, "mesh": (data, model)}


# --------------------------------------------------- group-bounded commits

@dataclasses.dataclass
class GroupCommitStats:
    steps: int
    group_size: int
    makespan: float
    barrier_stall: float
    per_step_barrier_makespan: float

    @property
    def speedup(self) -> float:
        return self.per_step_barrier_makespan / self.makespan


class GroupCommitScheduler:
    """Discrete-event model of group-bounded out-of-order commits.

    Workers process steps with i.i.d. heavy-tailed latencies.  Under a
    per-step barrier (G=1, the Zone-Write analogue) every step waits for the
    slowest worker.  With a commit group of G steps (Zone-Append analogue),
    each worker runs its G steps asynchronously and the barrier lands only
    at the group boundary -- stalls amortize exactly like the paper's
    intra-zone parallelism, at the cost of a G-entry commit table per group
    (compact-stripe-table analogue, ceil(log2 G) bits per entry).
    """

    def __init__(self, n_workers: int, *, mean: float = 1.0,
                 straggle_p: float = 0.05, straggle_factor: float = 4.0,
                 seed: int = 0):
        self.n = n_workers
        self.mean = mean
        self.p = straggle_p
        self.f = straggle_factor
        self.rng = np.random.default_rng(seed)

    def _latencies(self, steps: int) -> np.ndarray:
        base = self.rng.exponential(self.mean * 0.2, (steps, self.n)) + self.mean * 0.8
        straggle = self.rng.random((steps, self.n)) < self.p
        return np.where(straggle, base * self.f, base)

    def simulate(self, steps: int, group_size: int) -> GroupCommitStats:
        lat = self._latencies(steps)
        g = max(1, group_size)
        n_groups = math.ceil(steps / g)
        makespan = 0.0
        stall = 0.0
        for gi in range(n_groups):
            block = lat[gi * g : (gi + 1) * g]  # (<=g, n)
            per_worker = block.sum(axis=0)  # async within the group
            t = per_worker.max()
            makespan += t
            stall += t * self.n - per_worker.sum()
        # per-step barrier baseline on the same latency draws
        base = lat.max(axis=1).sum()
        return GroupCommitStats(
            steps=steps, group_size=g, makespan=makespan,
            barrier_stall=stall, per_step_barrier_makespan=base,
        )

    def commit_table_bits(self, group_size: int) -> int:
        """CST-analogue metadata cost per commit group."""
        return self.n * group_size * max(1, math.ceil(math.log2(max(group_size, 2))))
