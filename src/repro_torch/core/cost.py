"""Lambda cost model — paper §2's economics, reproduced exactly.

"Lambda invocation is charged in terms of memory and time; at the time of
writing, each GB/s costs $0.000016667. ... let's assume a (generous) instance
with 2GB memory running for 300ms; this translates into 100,000 queries per
US dollar. The beauty of the serverless cost model is that query load is
entirely fungible — 10 QPS for 10,000 seconds or 100 QPS for 1,000 seconds
costs exactly the same."
"""

from __future__ import annotations

import dataclasses


GB = 1024 ** 3

# AWS Lambda pricing at the time of the paper's writing.
PRICE_PER_GB_S = 0.000016667
PRICE_PER_REQUEST = 0.0000002   # $0.20 / 1M requests (ignored by the paper's
                                # round numbers; tracked separately here)
LAMBDA_BILLING_QUANTUM_S = 0.001  # post-2020 1 ms billing granularity


@dataclasses.dataclass(frozen=True)
class Invocation:
    memory_bytes: int
    duration_s: float
    cold_start: bool = False
    hedge: bool = False       # a backup leg fired for tail mitigation
    idle: bool = False        # keep-alive ping: standby capacity, not a query
    write: bool = False       # indexing work: delta pack / merge, not a query
    backfill: bool = False    # partial → full hydration upgrade, not a query


@dataclasses.dataclass
class CostLedger:
    """Accumulates per-invocation GB·s charges.

    Hedged backup legs are charged like any other invocation — FaaS offers
    no cancellation, so a losing leg runs (and bills) to completion — but
    they are additionally tracked in ``hedge_gb_seconds``/``hedge_invocations``
    so the tail-mitigation tax is visible next to the latency it buys.

    Keep-alive pings (``idle=True``) are the other standing tax: a standby
    replica pool answers no query but must be touched before the provider
    reaps it, and every touch bills. Attributing that spend separately
    (``idle_gb_seconds``/``idle_invocations``) is what lets a scale-down
    decision see what a pool costs just to exist — retire it and the idle
    line strictly stops growing.

    Writer invocations (``write=True``) are the NRT ingestion tax: delta
    packing and merge compaction run as Lambda work and bill like any
    invocation, but answer no query — a $/1k-queries number that silently
    folded indexing into serving would make update-heavy workloads look
    like expensive queries instead of cheap queries plus an indexing bill.

    Backfill charges (``backfill=True``) are the lazy-hydration deferral
    tax: a cold instance answers its first query from range reads of only
    the queried terms' blocks, then upgrades partial → full OFF the
    critical path. That upgrade still runs on the instance and bills
    GB·s, but it serves no query and adds no latency — folding it into
    serving would hide exactly the trade lazy hydration makes (cheap
    first response now, deferred bulk transfer later), so it gets its own
    line (``backfill_gb_seconds``/``backfill_invocations``).
    """

    gb_seconds: float = 0.0
    invocations: int = 0
    cold_starts: int = 0
    duration_s: float = 0.0
    hedge_gb_seconds: float = 0.0
    hedge_invocations: int = 0
    idle_gb_seconds: float = 0.0
    idle_invocations: int = 0
    write_gb_seconds: float = 0.0
    write_invocations: int = 0
    backfill_gb_seconds: float = 0.0
    backfill_invocations: int = 0
    # Admission-shed arrivals: rejected at the gateway with 429 before any
    # dispatch, so they bill NOTHING — the GB·s line exists only to pin that
    # claim (it must stay 0.0 forever; a nonzero value means a shed request
    # leaked into the fleet).
    shed_requests: int = 0
    shed_gb_seconds: float = 0.0

    def charge(self, inv: Invocation) -> float:
        quantum = LAMBDA_BILLING_QUANTUM_S
        billed_s = max(quantum,
                       -(-inv.duration_s // quantum) * quantum)  # ceil to quantum
        gbs = (inv.memory_bytes / GB) * billed_s
        self.gb_seconds += gbs
        self.invocations += 1
        self.cold_starts += int(inv.cold_start)
        self.duration_s += inv.duration_s
        if inv.hedge:
            self.hedge_gb_seconds += gbs
            self.hedge_invocations += 1
        if inv.idle:
            self.idle_gb_seconds += gbs
            self.idle_invocations += 1
        if inv.write:
            self.write_gb_seconds += gbs
            self.write_invocations += 1
        if inv.backfill:
            self.backfill_gb_seconds += gbs
            self.backfill_invocations += 1
        return gbs * PRICE_PER_GB_S

    def record_shed(self) -> None:
        """Count an admission-shed arrival. Sheds never dispatch, so no
        ``Invocation`` exists to charge — the count is the whole bill."""
        self.shed_requests += 1

    @property
    def compute_dollars(self) -> float:
        return self.gb_seconds * PRICE_PER_GB_S

    @property
    def request_dollars(self) -> float:
        return self.invocations * PRICE_PER_REQUEST

    @property
    def total_dollars(self) -> float:
        return self.compute_dollars + self.request_dollars

    @property
    def hedge_dollars(self) -> float:
        """The tail-mitigation tax: compute dollars spent on backup legs."""
        return self.hedge_gb_seconds * PRICE_PER_GB_S

    @property
    def idle_dollars(self) -> float:
        """The standby tax: compute dollars spent keeping pools warm."""
        return self.idle_gb_seconds * PRICE_PER_GB_S

    @property
    def write_dollars(self) -> float:
        """The ingestion tax: compute dollars spent packing deltas/merges."""
        return self.write_gb_seconds * PRICE_PER_GB_S

    @property
    def backfill_dollars(self) -> float:
        """The deferral tax: compute dollars spent upgrading partial → full."""
        return self.backfill_gb_seconds * PRICE_PER_GB_S

    def attribution(self) -> dict[str, float]:
        """Compute-dollar breakdown: serving / hedge / idle / write /
        backfill sum to ``compute_dollars`` (the classes are disjoint: a
        backup leg answers a query, a keep-alive answers none, a writer
        indexes, a backfill moves bytes for queries not yet asked)."""
        hedge, idle = self.hedge_dollars, self.idle_dollars
        write, backfill = self.write_dollars, self.backfill_dollars
        return {
            "serving": self.compute_dollars - hedge - idle - write - backfill,
            "hedge": hedge,
            "idle": idle,
            "write": write,
            "backfill": backfill,
        }

    def queries_per_dollar(self) -> float:
        if self.total_dollars == 0:
            return float("inf")
        return self.invocations / self.total_dollars

    def dollars_per_1k(self, n_queries: int) -> float:
        """$ per 1000 LOGICAL queries — the caller supplies the query count
        because hedging makes invocations ≠ queries (backup legs bill but
        answer no extra query).

        Zero-traffic guard: a just-built fleet that has served nothing and
        spent nothing reports $0 — the true unit cost of zero queries at
        zero spend, and what a dashboard should show before traffic, never
        a ZeroDivisionError. Spend WITHOUT queries (keep-alive pings,
        prewarming, writer invocations before the first search) is NaN:
        there is no per-query number that honestly describes a bill no
        query caused."""
        if n_queries <= 0:
            return 0.0 if self.total_dollars == 0.0 else float("nan")
        return self.total_dollars / n_queries * 1000.0


def paper_headline_cost(memory_gb: float = 2.0, duration_s: float = 0.3) -> float:
    """The paper's round-number calculation: queries per dollar for a 2GB
    instance running 300 ms (compute charge only, as the paper does)."""
    dollars_per_query = memory_gb * duration_s * PRICE_PER_GB_S
    return 1.0 / dollars_per_query


def fungibility_check(qps_a: float, secs_a: float, qps_b: float, secs_b: float,
                      memory_gb: float = 2.0, duration_s: float = 0.3) -> tuple[float, float]:
    """Cost of two load shapes with equal total queries — they must match
    (paper: 10 QPS × 10,000 s == 100 QPS × 1,000 s)."""
    cost = lambda qps, secs: qps * secs * memory_gb * duration_s * PRICE_PER_GB_S
    return cost(qps_a, secs_a), cost(qps_b, secs_b)


# -- TPU-side serving-cost adaptation ---------------------------------------
#
# The same fungible per-invocation accounting applied to TPU partitions: a
# "serverless TPU instance" is billed chip-seconds; the ledger form is
# identical, only the unit price changes. This lets benchmarks compare the
# paper's Lambda economics with a TPU-v5e serving deployment.

TPU_V5E_DOLLARS_PER_CHIP_HOUR = 1.2  # on-demand list price, order of magnitude


@dataclasses.dataclass
class TPUCostLedger:
    chip_seconds: float = 0.0
    invocations: int = 0

    def charge(self, n_chips: int, duration_s: float) -> float:
        cs = n_chips * duration_s
        self.chip_seconds += cs
        self.invocations += 1
        return cs / 3600.0 * TPU_V5E_DOLLARS_PER_CHIP_HOUR

    @property
    def total_dollars(self) -> float:
        return self.chip_seconds / 3600.0 * TPU_V5E_DOLLARS_PER_CHIP_HOUR

    def queries_per_dollar(self) -> float:
        if self.total_dollars == 0:
            return float("inf")
        return self.invocations / self.total_dollars
