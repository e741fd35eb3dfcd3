"""Deterministic synthetic serving traces.

A trace is a list of `Request`s ordered by arrival tick. Everything is
drawn from a seeded `random.Random`, so the same (seed, knobs) always
replays the same workload — the engine tests and the CI smoke job pin
their metrics against that determinism. Prompt/generation lengths are
drawn from small caller-chosen bucket sets (mixed-length traffic with a
bounded number of prefill compile shapes); arrivals are exponential
inter-arrival gaps rounded to whole engine ticks.

Two workload dimensions ride on top for the overload story:

  prefix_len   — every request shares one seeded system-prompt prefix
                 (`prefix_id=0`) prepended to its own tokens, the traffic
                 shape where refcounted prefix-block sharing pays.
  slo_classes  — a per-request SLO class (0 = strictest); the engine's
                 eviction policy preempts the loosest class first.

Both draw from a SECOND seeded stream so enabling them never perturbs
the base trace: `synthetic_trace(..., prefix_len=P)[i].prompt[P:]` is
exactly the prompt the same call without a prefix would produce.

`length_stats` summarizes the trace's written-length distribution
(mean/std/max per prompt bucket) — the workload-specific profile the
optimistic admission mode reserves `E[blocks] + k·sigma` from.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: `prompt` token ids arriving at engine tick
    `arrival`, asking for `max_new` greedily decoded tokens. `prefix_id`
    names the shared system-prompt its first `prefix_len` prompt tokens
    are (None = no shared prefix); `slo` is the latency class (0 =
    strictest — evicted last under pool pressure)."""
    rid: int
    arrival: int
    prompt: Tuple[int, ...]
    max_new: int
    prefix_id: Optional[int] = None
    prefix_len: int = 0
    slo: int = 0

    @property
    def context(self) -> int:
        """Ring-cache extent this request needs: prompt + generation."""
        return len(self.prompt) + self.max_new


def synthetic_trace(n_requests: int, *, vocab_size: int, seed: int = 0,
                    prompt_lens: Sequence[int] = (4, 8, 16),
                    gen_lens: Sequence[int] = (2, 4, 8),
                    mean_interarrival: float = 1.0,
                    prefix_len: int = 0,
                    slo_classes: Sequence[int] = (0,)) -> List[Request]:
    """The deterministic mixed-length trace the serve command replays.

    Token ids stay in [2, vocab_size) (0/1 reserved, matching the
    launchers' prompt generation). `mean_interarrival` <= 0 makes every
    request arrive at tick 0 (a closed-loop burst). `prompt_lens` sizes
    each request's OWN tokens; `prefix_len > 0` prepends one shared
    seeded prefix to every prompt (so full prompt lengths are
    `prefix_len + bucket`). Prefix tokens and SLO draws come from a
    separate seeded stream, so the base trace is unchanged by them."""
    if n_requests < 1:
        raise ValueError("synthetic_trace needs n_requests >= 1")
    if min(prompt_lens) < 1 or min(gen_lens) < 1:
        raise ValueError("prompt/gen length buckets must be >= 1")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    if not slo_classes:
        raise ValueError("slo_classes must be non-empty")
    rng = random.Random(seed)
    aux = random.Random((seed << 1) ^ 0x9E3779B9)   # never perturbs `rng`
    prefix = tuple(aux.randrange(2, vocab_size) for _ in range(prefix_len))
    classes = tuple(slo_classes)
    t = 0
    out = []
    for rid in range(n_requests):
        p = rng.choice(tuple(prompt_lens))
        g = rng.choice(tuple(gen_lens))
        own = tuple(rng.randrange(2, vocab_size) for _ in range(p))
        out.append(Request(rid=rid, arrival=t, prompt=prefix + own,
                           max_new=g,
                           prefix_id=(0 if prefix_len else None),
                           prefix_len=prefix_len,
                           slo=aux.choice(classes)))
        if mean_interarrival > 0:
            t += int(rng.expovariate(1.0 / mean_interarrival))
    return out


def trace_context(trace: Sequence[Request]) -> int:
    """The pool-wide ring extent: the largest prompt+gen in the trace."""
    return max(r.context for r in trace)


@dataclasses.dataclass(frozen=True)
class LengthStats:
    """Written-length distribution of a trace — the workload-specific
    profile optimistic admission reserves from. A request at prompt
    length P writes `P + max_new - 1` positions; `by_prompt[P]` holds
    (mean, std, max) over the trace's requests at that prompt bucket,
    and the top-level fields the whole-trace fallback for unseen
    buckets."""
    by_prompt: Dict[int, Tuple[float, float, int]]
    mean: float
    std: float
    max: int

    def expected_written(self, prompt_len: int, k: float = 0.0) -> float:
        """`E[written | prompt bucket] + k·sigma`, clamped to [1, bucket
        max] — the safety-margined expected footprint in positions."""
        m, s, mx = self.by_prompt.get(int(prompt_len),
                                      (self.mean, self.std, self.max))
        return max(1.0, min(m + max(k, 0.0) * s, float(mx)))


class OnlineLengthStats:
    """Exponentially-weighted online written-length stats — the live
    feedback loop closing the gap between the PROFILED distribution and
    the traffic actually served. Seeded from a static `LengthStats`
    (`base`), it is a drop-in for the engine's `stats=` parameter:
    `expected_written` answers from the EW estimate once a bucket has
    been observed and falls back to the profile until then, and the
    engine calls `observe` on every completion, so optimistic
    admission's `E[blocks] + k·sigma` reservation tracks the workload as
    it drifts. `state_dict`/`load_state` ride the engine snapshot so a
    restored engine keeps its learned distribution."""

    def __init__(self, base: Optional[LengthStats] = None,
                 alpha: float = 0.25):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.base = base
        self.alpha = float(alpha)
        # prompt bucket -> [ew_mean, ew_var, max_seen, n_observed]
        self._ew: Dict[int, List[float]] = {}

    def observe(self, prompt_len: int, written: int) -> None:
        """Fold one completed request's written length into its bucket.
        The first observation seeds the EW state from the profile's
        bucket (so one outlier can't whipsaw the reservation), then each
        update is a standard EW mean/variance step."""
        p = int(prompt_len)
        w = float(written)
        cell = self._ew.get(p)
        if cell is None:
            if self.base is not None:
                m0, s0, mx0 = self.base.by_prompt.get(
                    p, (self.base.mean, self.base.std, self.base.max))
                cell = [float(m0), float(s0) ** 2, float(mx0), 0.0]
            else:
                cell = [w, 0.0, w, 0.0]
            self._ew[p] = cell
        a = self.alpha
        d = w - cell[0]
        cell[0] += a * d
        cell[1] = (1.0 - a) * (cell[1] + a * d * d)
        cell[2] = max(cell[2], w)
        cell[3] += 1.0

    def expected_written(self, prompt_len: int, k: float = 0.0) -> float:
        """`E[written | bucket] + k·sigma` from the EW estimate (profile
        fallback for never-observed buckets), clamped to [1, max seen]."""
        cell = self._ew.get(int(prompt_len))
        if cell is None or cell[3] < 1:
            if self.base is not None:
                return self.base.expected_written(prompt_len, k)
            return 1.0
        m, var, mx = cell[0], cell[1], cell[2]
        return max(1.0, min(m + max(k, 0.0) * (var ** 0.5), mx))

    def sigma(self, prompt_len: int) -> float:
        """The live per-bucket sigma (0 for unobserved buckets)."""
        cell = self._ew.get(int(prompt_len))
        return (cell[1] ** 0.5) if cell and cell[3] >= 1 else 0.0

    def summary(self) -> Dict:
        """What `ServeReport.observed_lengths` carries: observation count
        plus the observation-weighted mean/sigma and per-bucket state."""
        obs = sum(c[3] for c in self._ew.values())
        if not obs:
            return {"observations": 0}
        mean = sum(c[0] * c[3] for c in self._ew.values()) / obs
        sig = (sum(c[1] * c[3] for c in self._ew.values()) / obs) ** 0.5
        return {"observations": int(obs),
                "mean_written": round(mean, 3),
                "sigma_written": round(sig, 3),
                "by_prompt": {p: {"mean": round(c[0], 3),
                                  "sigma": round(c[1] ** 0.5, 3),
                                  "max": int(c[2]), "n": int(c[3])}
                              for p, c in sorted(self._ew.items())}}

    def state_dict(self) -> Dict:
        return {str(p): list(c) for p, c in self._ew.items()}

    def load_state(self, state: Dict) -> None:
        self._ew = {int(p): [float(x) for x in c]
                    for p, c in state.items()}


def length_stats(trace: Sequence[Request]) -> LengthStats:
    """Per-prompt-bucket (mean, std, max) of written positions."""
    if not trace:
        raise ValueError("length_stats needs a non-empty trace")

    def _stats(vals: List[int]) -> Tuple[float, float, int]:
        m = sum(vals) / len(vals)
        var = sum((v - m) ** 2 for v in vals) / len(vals)
        return (m, var ** 0.5, max(vals))

    groups: Dict[int, List[int]] = {}
    for r in trace:
        groups.setdefault(len(r.prompt), []).append(
            len(r.prompt) + r.max_new - 1)
    overall = _stats([w for vals in groups.values() for w in vals])
    return LengthStats(by_prompt={p: _stats(v) for p, v in groups.items()},
                       mean=overall[0], std=overall[1], max=overall[2])


def describe_trace(trace: Sequence[Request]) -> str:
    p = sorted({len(r.prompt) for r in trace})
    g = sorted({r.max_new for r in trace})
    span = trace[-1].arrival - trace[0].arrival if trace else 0
    pfx = ""
    if any(r.prefix_id is not None for r in trace):
        pfx = f" shared_prefix={max(r.prefix_len for r in trace)}"
    return (f"{len(trace)} requests over {span + 1} ticks, "
            f"prompt_lens={p} gen_lens={g} context={trace_context(trace)}"
            f"{pfx}")
