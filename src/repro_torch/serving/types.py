"""Request/completion records and small stats helpers.

Shared by every engine role (serving/engine.py, serving/workers.py)
and by the benchmarks/tests, so the prefill/decode worker split does
not churn imports: `Request` is the unit a parcel carries to the
engine, `Completion` the value its LCO resolves to.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # optional SLO deadlines (obs/slo.py): a request carrying either
    # is goodput-tracked; TTFT is checked against ttft_s, ITL against
    # the p95 of itl_s.  None = untracked.
    ttft_deadline_ms: Optional[float] = None
    itl_deadline_ms: Optional[float] = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]
    prefill_s: float
    decode_s: float
    preemptions: int = 0
    # submit -> first sampled token (survives preemption: the first
    # token is only ever sampled once)
    ttft_s: float = 0.0
    # gaps between consecutive sampled tokens (inter-token latencies)
    itl_s: List[float] = dataclasses.field(default_factory=list)


def _mean(xs) -> float:
    return float(np.mean(xs)) if len(xs) else 0.0


def _pct(xs, q: float) -> float:
    return float(np.percentile(xs, q)) if len(xs) else 0.0
