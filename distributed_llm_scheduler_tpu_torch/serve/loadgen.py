"""Deterministic open-loop load generation for the serving front-end.

An ONLINE serving evaluation needs requests that arrive over time,
independent of how fast the server drains them (open-loop: a slow
server grows a queue instead of slowing the generator down — the regime
where SLOs break).  This module produces that arrival process two ways:

* :func:`poisson_arrivals` — a seeded Poisson process (exponential
  inter-arrival gaps) with per-request prompt-length / max-tokens /
  priority draws, all from one ``numpy.random.RandomState``.  The
  legacy ``RandomState`` generator is stability-guaranteed by numpy, so
  the same seed yields the bitwise-identical schedule on any machine or
  process — the determinism the serve bench's repeat-run gate and the
  cross-process test lean on.
* trace files (``dls.arrivals/1``) — :func:`save_trace` /
  :func:`load_trace` round-trip an arrival schedule through JSON so a
  scenario can be replayed exactly (or hand-written) without the
  generator.

Prompt CONTENT is derived, not stored: :func:`prompt_token_ids` keys a
``RandomState`` off ``(seed, crc32(rid))``, so any holder of an
:class:`Arrival` reconstructs the same tokens — traces stay small and
replays stay exact.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.serve.
loadgen``, whole: numpy only, seeded identically, so a schedule and its
prompts are the JAX package's.
"""

from __future__ import annotations

import hashlib
import json
import zlib
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

#: trace-file schema tag (validated by :func:`validate_trace_obj`)
TRACE_SCHEMA = "dls.arrivals/1"


@dataclass(frozen=True)
class Arrival:
    """One open-loop request arrival.

    ``t`` is the arrival offset in seconds from scenario start;
    ``priority`` is the tier (0 = highest; higher numbers are
    load-sheddable).  Prompt tokens are derived from the rid via
    :func:`prompt_token_ids`, not carried here.
    """

    rid: str
    t: float
    prompt_len: int
    max_new_tokens: int
    priority: int = 0

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)


def poisson_arrivals(
    rate_rps: float,
    n_requests: int,
    seed: int,
    *,
    prompt_lens: Sequence[int] = (8,),
    max_new_tokens: Sequence[int] = (8,),
    priorities: Sequence[int] = (0,),
    priority_weights: Optional[Sequence[float]] = None,
    rid_prefix: str = "r",
) -> List[Arrival]:
    """Seeded Poisson arrival schedule: ``n_requests`` arrivals at mean
    rate ``rate_rps``, prompt length / decode budget / priority drawn
    uniformly (or per ``priority_weights``) from the given choices.

    Same ``(seed, parameters)`` -> bitwise-identical schedule, across
    processes and platforms (legacy ``RandomState`` stability).
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    rng = np.random.RandomState(seed)
    p = None
    if priority_weights is not None:
        if len(priority_weights) != len(priorities):
            raise ValueError(
                f"{len(priority_weights)} weights for "
                f"{len(priorities)} priorities"
            )
        total = float(sum(priority_weights))
        p = [w / total for w in priority_weights]
    out: List[Arrival] = []
    t = 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        out.append(Arrival(
            rid=f"{rid_prefix}{i}",
            t=t,
            prompt_len=int(rng.choice(list(prompt_lens))),
            max_new_tokens=int(rng.choice(list(max_new_tokens))),
            priority=int(rng.choice(list(priorities), p=p)),
        ))
    return out


def session_arrivals(
    rate_rps: float,
    n_sessions: int,
    seed: int,
    *,
    system_len: int,
    user_len: int,
    turns: int = 2,
    max_new_tokens: Sequence[int] = (8,),
    priorities: Sequence[int] = (0,),
    priority_weights: Optional[Sequence[float]] = None,
    think_time_s: float = 0.05,
    rid_prefix: str = "s",
) -> List[Arrival]:
    """Deterministic shared-prefix / multi-turn session schedule.

    Session STARTS are a seeded Poisson process at ``rate_rps``; each
    session then resubmits ``turns`` times with exponential think-time
    gaps, every turn growing the prompt by ``user_len`` tokens on top of
    the shared ``system_len``-token system prompt (turn ``k`` arrives
    with ``prompt_len = system_len + (k+1) * user_len``).  Rids are
    derived — ``{prefix}{i}t{k}`` — so :func:`session_prompt_token_ids`
    can reconstruct each turn's prompt as the EXACT extension of the
    previous turn's (and of every other session's system prompt), which
    is what makes the workload prefix-shareable.  Plain
    :class:`Arrival` rows: the same ``dls.arrivals/1`` trace round-trip,
    digest, and replay machinery applies unchanged.
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n_sessions < 1:
        raise ValueError(f"n_sessions must be >= 1, got {n_sessions}")
    if turns < 1:
        raise ValueError(f"turns must be >= 1, got {turns}")
    if system_len < 1 or user_len < 1:
        raise ValueError(
            f"system_len/user_len must be >= 1, got "
            f"{system_len}/{user_len}"
        )
    rng = np.random.RandomState(seed)
    p = None
    if priority_weights is not None:
        if len(priority_weights) != len(priorities):
            raise ValueError(
                f"{len(priority_weights)} weights for "
                f"{len(priorities)} priorities"
            )
        total = float(sum(priority_weights))
        p = [w / total for w in priority_weights]
    out: List[Arrival] = []
    t = 0.0
    for i in range(n_sessions):
        t += float(rng.exponential(1.0 / rate_rps))
        prio = int(rng.choice(list(priorities), p=p))
        tk = t
        for k in range(turns):
            if k > 0:
                tk += float(rng.exponential(think_time_s))
            out.append(Arrival(
                rid=f"{rid_prefix}{i}t{k}",
                t=tk,
                prompt_len=system_len + (k + 1) * user_len,
                max_new_tokens=int(rng.choice(list(max_new_tokens))),
                priority=prio,
            ))
    out.sort(key=lambda a: (a.t, a.rid))
    return out


def mixed_long_prompt_arrivals(
    rate_rps: float,
    n_requests: int,
    seed: int,
    *,
    short_lens: Sequence[int] = (3, 5, 8),
    long_len: int = 24,
    long_every: int = 8,
    max_new_tokens: Sequence[int] = (3,),
    long_max_new_tokens: int = 4,
    priorities: Sequence[int] = (0,),
    priority_weights: Optional[Sequence[float]] = None,
    rid_prefix: str = "m",
) -> List[Arrival]:
    """Poisson short-prompt traffic with sparse very-long prompts: the
    interference shape where whole-prompt admission cliffs (one long
    prefill stalls every in-flight decode) and chunked prefill pays off.

    Every ``long_every``-th arrival (1-indexed: arrivals ``long_every``,
    ``2*long_every``, ...) is a ``long_len``-token prompt with its own
    decode budget; the rest draw from ``short_lens``.  The long cadence
    is deterministic by POSITION, not by draw, so the long/short
    interleaving is identical across seeds that only reshuffle the
    short-prompt draws.  Plain :class:`Arrival` rows — the same
    ``dls.arrivals/1`` trace round-trip, digest, and replay machinery
    applies unchanged.
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if long_every < 2:
        raise ValueError(f"long_every must be >= 2, got {long_every}")
    if long_len <= max(short_lens):
        raise ValueError(
            f"long_len {long_len} must exceed the longest short prompt "
            f"{max(short_lens)}"
        )
    rng = np.random.RandomState(seed)
    p = None
    if priority_weights is not None:
        if len(priority_weights) != len(priorities):
            raise ValueError(
                f"{len(priority_weights)} weights for "
                f"{len(priorities)} priorities"
            )
        total = float(sum(priority_weights))
        p = [w / total for w in priority_weights]
    out: List[Arrival] = []
    t = 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        # draw unconditionally so the short-prompt stream is identical
        # whether or not this position is a long one
        plen = int(rng.choice(list(short_lens)))
        mnew = int(rng.choice(list(max_new_tokens)))
        prio = int(rng.choice(list(priorities), p=p))
        if (i + 1) % long_every == 0:
            plen, mnew = long_len, long_max_new_tokens
        out.append(Arrival(
            rid=f"{rid_prefix}{i}",
            t=t,
            prompt_len=plen,
            max_new_tokens=mnew,
            priority=prio,
        ))
    return out


def session_prompt_token_ids(
    rid: Any,
    prompt_len: int,
    vocab_size: int,
    seed: int = 0,
    *,
    system_len: int,
    user_len: int,
) -> np.ndarray:
    """Prompt materializer for :func:`session_arrivals` rids: the shared
    system chunk, then one derived user chunk per turn — so turn ``k``'s
    prompt is bitwise turn ``k-1``'s plus one more chunk, and EVERY
    session starts with the identical ``system_len`` tokens.

    ``rid`` must be ``{session}t{k}``; the chunks are derived through
    :func:`prompt_token_ids` under synthetic rids (``__system__`` and
    ``{session}u{j}``), so determinism and trace-free replay carry over.
    """
    srid = str(rid)
    sid, _, turn = srid.rpartition("t")
    if not sid or not turn.isdigit():
        raise ValueError(
            f"session rid must look like '<session>t<turn>', got {srid!r}"
        )
    k = int(turn)
    want = system_len + (k + 1) * user_len
    if prompt_len != want:
        raise ValueError(
            f"rid {srid!r} turn {k} implies prompt_len {want}, "
            f"got {prompt_len}"
        )
    parts = [prompt_token_ids("__system__", system_len, vocab_size, seed)]
    for j in range(k + 1):
        parts.append(
            prompt_token_ids(f"{sid}u{j}", user_len, vocab_size, seed)
        )
    return np.concatenate(parts, axis=1)


def prompt_token_ids(
    rid: Any, prompt_len: int, vocab_size: int, seed: int = 0
) -> np.ndarray:
    """Deterministic (1, prompt_len) int32 prompt for ``rid``.

    Keyed off ``(seed, crc32(rid))`` so the generator, the frontend,
    and a replay from a trace file all materialize the same tokens
    without the trace carrying them.  Token 0 is avoided (it doubles as
    padding in parts of the model zoo).
    """
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    key = zlib.crc32(str(rid).encode("utf-8")) & 0xFFFFFFFF
    rng = np.random.RandomState([seed & 0xFFFFFFFF, key])
    lo, hi = 1, max(2, vocab_size)
    return rng.randint(lo, hi, size=(1, prompt_len)).astype(np.int32)


# -- trace files ----------------------------------------------------------
def arrivals_to_json(arrivals: Sequence[Arrival]) -> Dict[str, Any]:
    return {
        "schema": TRACE_SCHEMA,
        "arrivals": [a.to_json() for a in arrivals],
    }


def validate_trace_obj(obj: Any) -> List[str]:
    """Structural check of a ``dls.arrivals/1`` dict; returns
    human-readable problems (empty list == valid)."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return [f"trace is {type(obj).__name__}, not dict"]
    if obj.get("schema") != TRACE_SCHEMA:
        errs.append(
            f"schema is {obj.get('schema')!r}, want {TRACE_SCHEMA!r}"
        )
    rows = obj.get("arrivals")
    if not isinstance(rows, list) or not rows:
        return errs + ["arrivals block missing, not a list, or empty"]
    seen = set()
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            errs.append(f"arrivals[{i}] is not a dict")
            continue
        rid = row.get("rid")
        if not isinstance(rid, str) or not rid:
            errs.append(f"arrivals[{i}] rid missing or not a string")
        elif rid in seen:
            errs.append(f"arrivals[{i}] duplicate rid {rid!r}")
        else:
            seen.add(rid)
        t = row.get("t")
        if not isinstance(t, (int, float)) or isinstance(t, bool) or t < 0:
            errs.append(f"arrivals[{i}] t must be a number >= 0")
        for f, lo in (("prompt_len", 1), ("max_new_tokens", 1),
                      ("priority", 0)):
            v = row.get(f)
            if not isinstance(v, int) or isinstance(v, bool) or v < lo:
                errs.append(f"arrivals[{i}] {f} must be an int >= {lo}")
    return errs


def load_trace(path: str) -> List[Arrival]:
    """Parse + validate a ``dls.arrivals/1`` trace file; raises
    ``ValueError`` on malformed content (the ``serve`` CLI maps that to
    exit 2)."""
    with open(path) as f:
        obj = json.load(f)
    errs = validate_trace_obj(obj)
    if errs:
        raise ValueError(
            f"malformed arrival trace {path}: " + "; ".join(errs[:5])
        )
    return [
        Arrival(
            rid=row["rid"], t=float(row["t"]),
            prompt_len=int(row["prompt_len"]),
            max_new_tokens=int(row["max_new_tokens"]),
            priority=int(row["priority"]),
        )
        for row in obj["arrivals"]
    ]


def save_trace(arrivals: Sequence[Arrival], path: str) -> None:
    with open(path, "w") as f:
        json.dump(arrivals_to_json(arrivals), f, indent=1, sort_keys=True)


def schedule_digest(arrivals: Sequence[Arrival]) -> str:
    """sha256 over the canonical JSON schedule — the cross-process
    determinism probe (two processes with the same seed must print the
    same digest)."""
    payload = json.dumps(
        [a.to_json() for a in arrivals], sort_keys=True
    ).encode("utf-8")
    return hashlib.sha256(payload).hexdigest()


__all__ = [
    "Arrival",
    "TRACE_SCHEMA",
    "arrivals_to_json",
    "load_trace",
    "mixed_long_prompt_arrivals",
    "poisson_arrivals",
    "prompt_token_ids",
    "save_trace",
    "schedule_digest",
    "session_arrivals",
    "session_prompt_token_ids",
    "validate_trace_obj",
]
