"""Stale Synchronous Parallel (SSP) clock semantics (Ho et al., 2013),
port of ``repro/core/ssp.py``.

  * every worker owns a clock c_p (iterations completed);
  * a worker may begin iteration c only if c - min_q c_q <= s;
  * reads contain all updates with clock <= c - s - 1.

``ssp_delay_schedule`` turns the discipline, run over per-iteration worker
durations, into the ``[T, P]`` delay table the ``ssp`` engine mode feeds to
the delayed-gradient step. Clock arithmetic is float32, as the reference
computes it: a start gated on a finish is bitwise equal to it, and the
table resolves those ties by equality, so another precision would change
the table. It runs on the host CPU (a [T, P] loop of tiny ops).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SSPConfig:
    num_workers: int
    bound: int  # s: max clock drift between fastest and slowest worker


def simulate_ssp_clocks(cfg: SSPConfig, speeds) -> dict:
    """Event-driven SSP simulation on ``speeds``, the [T, P] positive
    durations of each worker's t-th iteration (float32). Returns finish and
    start times, per-iteration stalls and clock-spread diagnostics."""
    speeds = torch.as_tensor(speeds).to("cpu", torch.float32)
    t_steps, p = speeds.shape
    gate_rank = max(p - 1 - cfg.bound, 0)
    finish = torch.zeros((p,), dtype=torch.float32)
    stalls, finishes, starts = [], [], []
    for t in range(t_steps):
        # A worker may start clock c once the slowest finished c - s.
        if cfg.bound >= p:
            start = finish
        else:
            gate = torch.sort(finish).values[gate_rank]
            start = torch.maximum(finish, gate)
        new_finish = start + speeds[t]
        stalls.append(start - finish)
        finishes.append(new_finish)
        starts.append(start)
        finish = new_finish
    finishes = torch.stack(finishes) if t_steps else speeds.clone()
    starts = torch.stack(starts) if t_steps else speeds.clone()
    stalls = torch.stack(stalls) if t_steps else speeds.clone()
    return {
        "finish_times": finishes,
        "start_times": starts,
        "stalls": stalls,
        "total_stall": stalls.sum(),
        "makespan": finishes[-1].max(),
        "clock_spread": finishes.max(dim=1).values - finishes.min(dim=1).values,
        "worker_order": torch.argsort(finishes, dim=1),
    }


def sample_worker_durations(gen: torch.Generator, t_steps: int,
                            num_workers: int, mean_dur: float = 1.0,
                            cv: float = 0.5) -> torch.Tensor:
    """Lognormal per-(iteration, worker) durations with the given mean and
    coefficient of variation, drawn from ``gen`` (float32 on its device).
    The draws differ from ``jax.random``'s."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    sigma = torch.sqrt(torch.log1p(f32(cv ** 2)))
    mu = torch.log(f32(mean_dur)) - sigma ** 2 / 2
    z = torch.randn((t_steps, num_workers), generator=gen,
                    device=gen.device)
    return torch.exp(mu.to(gen.device) + sigma.to(gen.device) * z)


def ssp_delay_schedule(cfg: SSPConfig, speeds) -> torch.Tensor:
    """The [T, P] int32 delay table of the SSP clock discipline: when worker
    p starts clock c, how many clocks behind c is the slowest worker? That
    gap is the staleness of what p reads for its c-th update. Values lie in
    ``[0, cfg.bound]``; the table is on the CPU."""
    sim = simulate_ssp_clocks(cfg, speeds)
    finishes, starts = sim["finish_times"], sim["start_times"]
    t_steps = finishes.shape[0]
    # done[c, p, q] = clocks worker q completed by the time p starts clock
    # c = #{k : finish[k, q] <= start[c, p]}; each worker's finish times
    # are non-decreasing, so this is one searchsorted per q.
    flat = starts.reshape(-1).contiguous()
    done = torch.stack([
        torch.searchsorted(finishes[:, q].contiguous(), flat, right=True)
        for q in range(cfg.num_workers)], dim=1)          # [T*P, P(q)]
    done = done.reshape(t_steps, cfg.num_workers, cfg.num_workers)
    gap = torch.arange(t_steps)[:, None] - done.min(dim=2).values
    return torch.clamp(gap, 0, cfg.bound).to(torch.int32)


def ssp_throughput_model(cfg: SSPConfig, mean_dur: float, cv: float,
                         gen: torch.Generator, t_steps: int = 200) -> dict:
    """Makespan speedup of SSP(s) over BSP (s = 0) on sampled lognormal
    durations: the system-throughput half of the staleness trade-off."""
    durs = sample_worker_durations(gen, t_steps, cfg.num_workers, mean_dur,
                                   cv)
    ssp = simulate_ssp_clocks(cfg, durs)
    bsp = simulate_ssp_clocks(dataclasses.replace(cfg, bound=0), durs)
    return {
        "ssp_makespan": ssp["makespan"],
        "bsp_makespan": bsp["makespan"],
        "throughput_gain": bsp["makespan"] / ssp["makespan"],
    }
