"""API Gateway analogue: REST-ish routing in front of the FaaS runtime.

Paper §2: "all operations are proxied through REST endpoints provided by the
API Gateway. The final product is a full-featured search application
accessible to a search client."

The gateway owns route → function mapping, request/response envelopes, and
adds the gateway's own (small) proxy overhead so end-to-end latency matches
what the paper measures "from the browser".

Batched routes additionally get an ADMISSION QUEUE with an adaptive
micro-batch window: concurrent arrivals inside one window coalesce into a
single coordinator dispatch (for ``/search``: one vmapped invocation per
partition per window), which is how the gateway serves "interactive search
at unusual operating points" — amortizing a device call over whatever
concurrency the arrival process actually offers. The window is sized from
the trailing arrival rate, clamped by a p99-latency budget, and collapses
to ZERO under sparse traffic so a lone query never waits on a window that
no second query will ever join.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

from repro_torch.core.runtime import (FaaSRuntime, InvocationRecord,
                                RetriesExhausted, nearest_rank_percentiles)


GATEWAY_OVERHEAD_S = 0.010   # API-Gateway proxy+auth overhead (~10 ms)


@dataclasses.dataclass(frozen=True)
class BackpressurePolicy:
    """Admission backpressure for a batched route.

    A window that closes at ``max_batch`` (a HARD flush) means the arrival
    process outran the widest batch the route may dispatch. One hard flush
    is a burst; ``consecutive_hard_flushes`` of them in a row is overload,
    and from then on new arrivals are SHED: resolved immediately with a 429
    and a ``Retry-After`` derived from the trailing drain rate (the seconds
    the fleet needs to dispatch one more ``max_batch`` at its observed
    throughput). Shed requests never dispatch and bill nothing — they are
    counted on :class:`~repro_torch.core.cost.CostLedger`'s ``shed_*`` line so an
    operator can see refused demand next to the spend it did not cause."""

    consecutive_hard_flushes: int = 3
    drain_window_s: float = 1.0        # trailing window for the drain rate
    min_retry_after_s: float = 0.050
    max_retry_after_s: float = 2.0

    def __post_init__(self) -> None:
        if self.consecutive_hard_flushes < 1:
            raise ValueError("consecutive_hard_flushes must be >= 1")
        if self.drain_window_s <= 0:
            raise ValueError("drain_window_s must be > 0")
        if not 0 <= self.min_retry_after_s <= self.max_retry_after_s:
            raise ValueError("need 0 <= min_retry_after_s <= max_retry_after_s")

    def retry_after_s(self, batch: int, drain_qps: float) -> float:
        """Seconds until the fleet should have drained one more ``batch``
        requests at the trailing rate — the honest Retry-After."""
        if drain_qps <= 0.0:
            return self.max_retry_after_s
        return min(self.max_retry_after_s,
                   max(self.min_retry_after_s, batch / drain_qps))


class RouteError(Exception):
    pass


class BadRequest(Exception):
    """A malformed request body (e.g. an empty micro-batch). Raised by a
    coordinator or an admission validator; the gateway maps it to a 400 —
    the client's error — instead of the 502 a Lambda failure earns, and a
    batched route rejects it AT ADMISSION, before anything dispatches."""


@dataclasses.dataclass(frozen=True)
class Response:
    status: int
    body: Any
    latency_s: float
    record: InvocationRecord | None = None

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300


class PendingResponse:
    """Handle for a request admitted to a batching window. The response
    materializes when the window flushes (immediately, when the adaptive
    window is zero); reading ``response`` before then raises — in a
    virtual-clock simulation that is always a driver bug, never a race."""

    __slots__ = ("t_arrival", "_response")

    def __init__(self, t_arrival: float) -> None:
        self.t_arrival = t_arrival
        self._response: Response | None = None

    def done(self) -> bool:
        return self._response is not None

    @property
    def response(self) -> Response:
        if self._response is None:
            raise RuntimeError("window still open — flush the gateway (or "
                               "submit a later arrival) before reading")
        return self._response

    def _resolve(self, response: Response) -> None:
        self._response = response


@dataclasses.dataclass
class WindowPolicy:
    """Sizing rule for the adaptive micro-batch window.

    On the FIRST arrival of a window the gateway picks how long to hold the
    admission queue open:

    * sparse traffic (trailing rate < ``sparse_qps``) → window 0: a lone
      query dispatches immediately and never pays for a batch that will not
      form;
    * otherwise ``target_batch / rate`` — just long enough for the arrival
      process to offer ~``target_batch`` coalescable queries — capped at
      ``max_window_s``;
    * clamped so the added wait cannot push the route past its latency
      budget: window ≤ ``p99_budget_s`` − the route's trailing p99 (over
      the ``p99_window`` most recent requests). A route already near
      budget stops batching before it starts breaching.
    """

    max_window_s: float = 0.050
    target_batch: int = 8
    rate_window_s: float = 1.0
    sparse_qps: float = 2.0            # below this, window -> 0
    p99_budget_s: float | None = 0.300
    p99_window: int = 64               # trailing requests for the budget clamp
    max_batch: int = 64                # hard flush at this many queued
    backpressure: BackpressurePolicy | None = None   # None -> never shed

    def window_s(self, rate_qps: float, route_p99_s: float) -> float:
        if rate_qps < self.sparse_qps:
            return 0.0
        w = min(self.max_window_s, self.target_batch / max(rate_qps, 1e-9))
        if self.p99_budget_s is not None and not math.isnan(route_p99_s):
            w = min(w, max(0.0, self.p99_budget_s - route_p99_s))
        return w


# A coordinator route fans one request out to several functions (e.g.
# scatter-gather over partitions) and owns its own latency accounting:
# (body, t_arrival) -> (result, latency_s, representative record | None).
Coordinator = Callable[[Any, "float | None"],
                       "tuple[Any, float, InvocationRecord | None]"]

# A batch coordinator dispatches one WINDOW of admitted requests at the
# window-close instant: (bodies, t_arrivals, t_dispatch) -> per-request
# (result, dispatch_latency_s) pairs, in admission order. The gateway adds
# each request's queue wait (t_dispatch - t_arrival) and proxy overhead.
BatchCoordinator = Callable[[list, list, float], "list[tuple[Any, float]]"]


class _AdmissionQueue:
    """One batched route's open window: admitted requests + close time."""

    def __init__(self, policy: WindowPolicy) -> None:
        self.policy = policy
        self.pending: list[tuple[Any, PendingResponse]] = []
        self.window_close = 0.0
        self.arrivals: list[float] = []     # trailing-rate history
        self.waits: list[float] = []        # per-request t_dispatch - t_arrival
        self.batch_sizes: list[int] = []    # per-flush, for introspection
        # backpressure state: consecutive max_batch flushes, the trailing
        # drain history (t_dispatch, batch size), shed arrivals, and the
        # horizon new arrivals are shed until once the threshold trips
        self.hard_flushes = 0
        self.flushes: list[tuple[float, int]] = []
        self.sheds: list[float] = []
        self.shed_until = 0.0

    def rate(self, now: float) -> float:
        cutoff = now - self.policy.rate_window_s
        self.arrivals = [t for t in self.arrivals if t > cutoff]
        return len(self.arrivals) / self.policy.rate_window_s

    def drain_qps(self, now: float, window_s: float) -> float:
        """Requests DISPATCHED per second over the trailing window — the
        throughput the fleet is actually sustaining, as opposed to the
        arrival rate the clients are offering."""
        cutoff = now - window_s
        self.flushes = [(t, n) for t, n in self.flushes if t > cutoff]
        return sum(n for _, n in self.flushes) / window_s


class Gateway:
    def __init__(self, runtime: FaaSRuntime) -> None:
        self.runtime = runtime
        self._routes: dict[tuple[str, str], "str | Coordinator"] = {}
        # batched routes: admission queue + window policy per route
        self._batched: dict[tuple[str, str],
                            tuple[BatchCoordinator, "Callable | None"]] = {}
        self._queues: dict[tuple[str, str], _AdmissionQueue] = {}
        # shed-notification hooks (e.g. the autoscaler counting refused
        # demand it would otherwise never see in the invocation records)
        self._on_shed: dict[tuple[str, str], Callable[[float], None]] = {}
        # end-to-end latency log per route (what "the browser" saw) — the
        # runtime's records are per-invocation, so a hedged or fanned-out
        # request has no single record to read percentiles from
        self.latencies: dict[tuple[str, str], list[float]] = {}

    def route(self, method: str, path: str, fn: "str | Coordinator") -> None:
        """Map method+path to a runtime function name, or to a coordinator
        callable that orchestrates several invocations (scatter-gather)."""
        self._routes[(method.upper(), path)] = fn

    def route_batched(self, method: str, path: str,
                      coordinator: BatchCoordinator, *,
                      policy: WindowPolicy | None = None,
                      admit: "Callable[[Any, float], Any] | None" = None,
                      on_shed: "Callable[[float], None] | None" = None
                      ) -> None:
        """Register a route whose :meth:`submit` arrivals coalesce through
        the adaptive micro-batch window into single batch dispatches.

        ``admit(body, t_arrival)`` runs at ADMISSION (not dispatch): it
        validates the body — raising :class:`BadRequest` rejects it with a
        400 before it can occupy the window — and may return an annotated
        replacement body (e.g. pinning the index generation the request
        must be served from, so a commit landing while the window is open
        can never retroactively move an already-admitted query)."""
        key = (method.upper(), path)
        self._batched[key] = (coordinator, admit)
        self._queues[key] = _AdmissionQueue(policy or WindowPolicy())
        if on_shed is not None:
            self._on_shed[key] = on_shed

    def request(self, method: str, path: str, body: Any = None,
                *, t_arrival: float | None = None) -> Response:
        key = (method.upper(), path)
        fn = self._routes.get(key)
        if fn is None:
            return Response(404, {"error": f"no route {method} {path}"}, 0.0)
        try:
            if callable(fn):
                result, lat, rec = fn(body, t_arrival)
            else:
                result, rec = self.runtime.invoke(fn, body,
                                                  t_arrival=t_arrival)
                lat = rec.latency_s
        except BadRequest as e:  # malformed body → 400, nothing dispatched
            return Response(400, {"error": str(e)}, GATEWAY_OVERHEAD_S)
        except RetriesExhausted as e:   # bounded retries ran out → typed 503
            return Response(503, {"error": str(e)}, GATEWAY_OVERHEAD_S)
        except Exception as e:  # Lambda error → 502 from the gateway
            return Response(502, {"error": str(e)}, GATEWAY_OVERHEAD_S)
        self.latencies.setdefault(key, []).append(lat + GATEWAY_OVERHEAD_S)
        return Response(200, result, lat + GATEWAY_OVERHEAD_S, rec)

    # -- the admission queue (batched routes) ---------------------------------

    def submit(self, method: str, path: str, body: Any = None,
               *, t_arrival: float | None = None) -> PendingResponse:
        """Admit a request to its route's micro-batch window.

        Arrivals must be submitted in nondecreasing ``t_arrival`` order (the
        virtual-clock discipline every driver already follows). A submission
        past the open window's close first flushes that window — so the
        caller of an EARLIER arrival can always read its response once any
        later arrival (or :meth:`flush`) has moved time past the close.
        Routes without a batch registration dispatch immediately through
        :meth:`request` and return an already-resolved handle."""
        key = (method.upper(), path)
        t0 = self.runtime.clock if t_arrival is None else t_arrival
        if key not in self._batched:
            handle = PendingResponse(t0)
            handle._resolve(self.request(method, path, body, t_arrival=t0))
            return handle
        q = self._queues[key]
        # a window whose close has passed flushes before the new arrival
        if q.pending and t0 >= q.window_close:
            self._flush_queue(key, q.window_close)

        coordinator, admit = self._batched[key]
        handle = PendingResponse(t0)
        # admission backpressure: past the consecutive-hard-flush threshold
        # the route sheds — a 429 the client can retry after the fleet has
        # had time to drain, billed to NOTHING (no dispatch, no charge; the
        # ledger's shed line is a count, not GB·s)
        if t0 < q.shed_until:
            retry_after = q.shed_until - t0
            self.runtime.ledger.record_shed()
            q.sheds.append(t0)
            hook = self._on_shed.get(key)
            if hook is not None:
                hook(t0)
            handle._resolve(Response(
                429, {"error": "admission backpressure: route overloaded",
                      "retry_after_s": retry_after}, GATEWAY_OVERHEAD_S))
            return handle
        if admit is not None:
            try:
                annotated = admit(body, t0)
            except BadRequest as e:
                handle._resolve(
                    Response(400, {"error": str(e)}, GATEWAY_OVERHEAD_S))
                return handle
            if annotated is not None:
                body = annotated

        q.arrivals.append(t0)
        if not q.pending:
            w = q.policy.window_s(q.rate(t0), self._route_p99(key, q))
            if w <= 0.0:                # sparse traffic: a lone query never
                q.pending.append((body, handle))   # waits on a window
                self._flush_queue(key, t0)
                return handle
            q.window_close = t0 + w
        q.pending.append((body, handle))
        if len(q.pending) >= q.policy.max_batch:
            self._flush_queue(key, t0, hard=True)  # hard cap: dispatch now
        return handle

    def flush(self, now: float | None = None) -> int:
        """Close due (or, with ``now=None``, ALL) open windows.

        Drivers call this when virtual time passes a window close with no
        further arrivals to trigger it — the analogue of the window timer
        firing — and once at end of run. Returns the number of windows
        flushed."""
        n = 0
        for key, q in self._queues.items():
            if not q.pending:
                continue
            if now is None or now >= q.window_close:
                self._flush_queue(key, q.window_close)
                n += 1
        return n

    def _route_p99(self, key: tuple[str, str], q: _AdmissionQueue) -> float:
        lats = self.latencies.get(key, [])
        return nearest_rank_percentiles(
            lats[-q.policy.p99_window:], qs=(0.99,))[0.99]

    def _flush_queue(self, key: tuple[str, str], t_dispatch: float,
                     *, hard: bool = False) -> None:
        q = self._queues[key]
        batch, q.pending = q.pending, []
        q.batch_sizes.append(len(batch))
        q.flushes.append((t_dispatch, len(batch)))
        if hard:
            # A max_batch flush dispatches the batch ONCE, right now. The
            # burst that filled it must not leak into the NEXT window's
            # sizing: those arrivals were already absorbed, and leaving them
            # in the trailing-rate history would make the reopened window
            # collapse toward zero (rate spike -> tiny window -> instant
            # re-flush), amplifying the very overload it should absorb.
            # Reseed with the dispatch instant rather than clearing outright:
            # an empty history would make the NEXT overload arrival read as
            # sparse traffic and dispatch solo — a soft flush that resets
            # the hard streak, so sustained overload would alternate
            # hard/solo forever and backpressure could never trip.
            q.arrivals[:] = [t_dispatch]
            q.hard_flushes += 1
            bp = q.policy.backpressure
            if bp is not None and q.hard_flushes >= bp.consecutive_hard_flushes:
                drain = q.drain_qps(t_dispatch, bp.drain_window_s)
                q.shed_until = max(
                    q.shed_until,
                    t_dispatch + bp.retry_after_s(len(batch), drain))
        else:
            q.hard_flushes = 0          # the arrival process fit its window
        coordinator, _ = self._batched[key]
        bodies = [b for b, _ in batch]
        arrivals = [h.t_arrival for _, h in batch]
        try:
            results = coordinator(bodies, arrivals, t_dispatch)
        except BadRequest as e:
            for _, handle in batch:
                handle._resolve(
                    Response(400, {"error": str(e)}, GATEWAY_OVERHEAD_S))
            return
        except RetriesExhausted as e:   # retries ran out → typed 503 each
            for _, handle in batch:
                handle._resolve(
                    Response(503, {"error": str(e)}, GATEWAY_OVERHEAD_S))
            return
        except Exception as e:          # whole-flight failure → 502 each
            for _, handle in batch:
                handle._resolve(
                    Response(502, {"error": str(e)}, GATEWAY_OVERHEAD_S))
            return
        for (_, handle), (result, disp_lat) in zip(batch, results):
            wait = t_dispatch - handle.t_arrival
            q.waits.append(wait)
            lat = wait + disp_lat + GATEWAY_OVERHEAD_S
            self.latencies.setdefault(key, []).append(lat)
            handle._resolve(Response(200, result, lat))

    def window_stats(self, method: str, path: str) -> dict:
        """Introspection for the route's admission queue: flush batch sizes
        and per-request added waits (a sparse-traffic run must show every
        wait at exactly zero — the window's no-added-latency contract)."""
        q = self._queues.get((method.upper(), path))
        if q is None:
            return {"batches": 0, "mean_batch": 0.0, "max_wait_s": 0.0,
                    "waits": [], "sheds": 0, "hard_flushes": 0}
        return {
            "batches": len(q.batch_sizes),
            "mean_batch": (sum(q.batch_sizes) / len(q.batch_sizes)
                           if q.batch_sizes else 0.0),
            "max_wait_s": max(q.waits, default=0.0),
            "waits": list(q.waits),
            "sheds": len(q.sheds),
            "hard_flushes": q.hard_flushes,
        }

    def latency_percentiles(self, method: str, path: str,
                            qs=(0.5, 0.9, 0.99)) -> dict[float, float]:
        """End-to-end latency quantiles for one route, over successful
        requests (the numbers the paper reports "from the browser")."""
        return nearest_rank_percentiles(
            self.latencies.get((method.upper(), path), []), qs)

    def routes(self) -> list[tuple[str, str, str]]:
        return [(m, p, f if isinstance(f, str)
                 else getattr(f, "__name__", "<coordinator>"))
                for (m, p), f in sorted(self._routes.items())]
