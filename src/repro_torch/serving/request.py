"""Request lifecycle for the continuous-batching serving engine.

A copy of ``repro.serving.request`` (numpy only).

A request moves through::

    submit() -> QUEUED -> PREFILL -> DECODING -> FINISHED
                      \\-> REJECTED          \\-> EVICTED

EVICTED covers user eviction (``finish_reason='evicted'``), fault
isolation (``'error'`` — a decode/prefill fault attributed to this
request), and the per-request watchdog (``'timeout'``).

Tokens stream to the caller through an optional ``on_token`` callback
(fired at every engine sync with the newly arrived token ids, in
emission order) and through :meth:`RequestHandle.tokens` snapshots.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

__all__ = ["RequestState", "Request", "RequestHandle", "TokenEvent"]


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODING = "decoding"
    FINISHED = "finished"
    EVICTED = "evicted"
    REJECTED = "rejected"

    @property
    def terminal(self) -> bool:
        return self in (
            RequestState.FINISHED,
            RequestState.EVICTED,
            RequestState.REJECTED,
        )


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token: (request id, position in the output, token)."""

    request_id: int
    index: int
    token: int


@dataclasses.dataclass
class Request:
    """Engine-internal request record. Users hold a RequestHandle."""

    id: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    temperature: float
    eos_id: int
    seed: int
    on_token: Optional[Callable] = None

    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    page_ids: List[int] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    # "eos" | "length" | "evicted" | "error" (fault isolation) |
    # "timeout" (request_timeout_s watchdog) | "rejected"
    finish_reason: Optional[str] = None

    # telemetry (wall-clock, perf_counter domain)
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.state.terminal

    def record_tokens(self, toks: List[int], now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        if self.t_first_token is None and toks:
            self.t_first_token = now
        self.tokens.extend(int(t) for t in toks)
        self.token_times.extend(now for _ in toks)


class RequestHandle:
    """User-facing view of a submitted request."""

    def __init__(self, engine, request: Request):
        self._engine = engine
        self._request = request

    @property
    def id(self) -> int:
        return self._request.id

    @property
    def state(self) -> RequestState:
        return self._request.state

    @property
    def finish_reason(self) -> Optional[str]:
        return self._request.finish_reason

    @property
    def done(self) -> bool:
        return self._request.done

    def tokens(self) -> List[int]:
        """Snapshot of tokens streamed so far (prompt excluded)."""
        return list(self._request.tokens)

    def result(self) -> List[int]:
        """Drive the engine until this request is terminal; return tokens."""
        self._engine.run(until=self)
        return self.tokens()

    def cancel(self) -> None:
        """Evict this request (mid-decode allowed); pages return to pool."""
        self._engine.evict(self)

    def latency_stats(self) -> Tuple[Optional[float], List[float]]:
        """(time-to-first-token, inter-token gaps) in seconds."""
        r = self._request
        ttft = (
            r.t_first_token - r.t_submit if r.t_first_token is not None else None
        )
        gaps = [
            r.token_times[i] - r.token_times[i - 1]
            for i in range(1, len(r.token_times))
        ]
        return ttft, gaps

    def __repr__(self) -> str:
        r = self._request
        return (
            f"RequestHandle(id={r.id}, state={r.state.value}, "
            f"tokens={len(r.tokens)}/{r.max_new_tokens})"
        )
