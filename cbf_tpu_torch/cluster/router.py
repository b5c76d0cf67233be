"""The cluster router: consistent-hash placement, cost-model admission,
work stealing, and the engine-shaped client surface (counterpart:
cbf_tpu/cluster/router.py, ported whole).

The router fronts M worker engines (`cluster.worker`) over the file
transport (`cluster.transport`). It deliberately presents the SAME
surface `run_loadgen` drives a single engine with — ``_running`` /
``start()`` / ``submit()`` / ``stop(drain=True)`` / ``prewarm()`` and
handles whose ``result()`` returns loadgen-compatible result objects —
so every existing harness (SLO sweeps, chaos legs, knee finding) runs
unmodified against a cluster.

Placement: ``submit`` computes the request's bucket signature and
places its LABEL on the consistent-hash ring (`cluster.ring`) — every
request of a bucket lands on the same engine, keeping that engine's
captured programs hot. Admission sizes the request against the
per-bucket cost model first: `CostModel.fits` is fail-open
(an unpriced shape or an absent model admits), a priced shape that
cannot fit the configured budget sheds with the typed
`~cbf_tpu_torch.serve.resilience.ShedError` BEFORE a request file is written.

Work stealing: when an engine's UNCLAIMED inbox depth crosses
``steal_threshold`` and another enrolled engine is idle (empty inbox,
nothing claimed), the poll loop relocates the oldest unclaimed request
file by atomic rename (`transport.steal`). A claimed — and therefore
possibly acknowledged — request is unreachable to the sweep by
construction: claims rename files OUT of the inbox before the worker's
WAL ``submitted`` fsync, so the never-steal-acked invariant is the
rename protocol itself, not a check. When a cost model is armed, the
sweep only steals onto an idle engine for which the request's bucket
is priced (a measured peak exists) — stealing onto an engine that
would pay a blind cold capture recreates the hotspot elsewhere;
without a model the sweep is fail-open like admission.

The poll loop also reaps outboxes: each response file resolves the
matching pending handle (end-to-end latency on the ROUTER's clock —
inbox wait and transport included, which is what the client
experiences) and is deleted. Failover and rolling restarts re-route
through :meth:`reroute_file` / :meth:`resubmit` / :meth:`synthesize`
(driven by `cluster.membership`, which owns the lease monitoring).
"""

from __future__ import annotations

import os
import time

from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.cluster import transport
from cbf_tpu_torch.cluster.ring import HashRing
from cbf_tpu_torch.serve import buckets as _buckets
from cbf_tpu_torch.serve import resilience

#: Generic telemetry event types this module emits (with
#: cluster.membership's, they union to obs.schema.CLUSTER_EVENT_TYPES).
EMITTED_EVENT_TYPES: tuple[str, ...] = ("cluster.route", "cluster.steal")


class _Outputs:
    """Scalar stand-in for a result's StepOutputs surface — loadgen
    folds these with np.min/np.sum, which accept scalars."""

    __slots__ = ("min_pairwise_distance", "infeasible_count")

    def __init__(self, min_pairwise_distance: float,
                 infeasible_count: int):
        self.min_pairwise_distance = min_pairwise_distance
        self.infeasible_count = infeasible_count


class RoutedResult:
    """One routed request's outcome, rebuilt from the worker's response
    payload with end-to-end timing on the router's clock."""

    __slots__ = ("request_id", "bucket", "n", "steps", "engine",
                 "latency_s", "queue_wait_s", "execute_s", "batch_fill",
                 "degraded", "ttfp_s", "outputs")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


class RoutedPending:
    """Client handle for one routed request (the cluster twin of the
    engine's PendingRequest — same ``result(timeout)`` contract)."""

    def __init__(self, request_id: str, key):
        self.request_id = request_id
        self._key = key      # BucketKey: loadgen's bucket_errors seam
        self._event = lockwitness.make_event("RoutedPending._event")
        self._result = None
        self._error: BaseException | None = None

    def _resolve(self, result=None, error=None) -> None:
        self._result, self._error = result, error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not served in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


def _error_from_payload(payload: dict) -> BaseException:
    """Rebuild a typed ServeError from a worker's error response. An
    unknown type degrades to the base ServeError — typed where
    possible, never silent."""
    name = payload.get("error_type") or "ServeError"
    msg = payload.get("message") or name
    cls = getattr(resilience, name, None)
    rid, bucket = payload.get("request_id"), payload.get("bucket")
    if isinstance(cls, type) and issubclass(cls, resilience.ServeError) \
            and cls is not resilience.FencedError:
        return cls(msg, request_id=rid, bucket=bucket)
    return resilience.ServeError(msg, request_id=rid, bucket=bucket)


class _Route:
    """Router-side bookkeeping for one in-flight request."""

    __slots__ = ("pending", "label", "engine", "t_submit")

    def __init__(self, pending, label, engine, t_submit):
        self.pending = pending
        self.label = label
        self.engine = engine
        self.t_submit = t_submit


class ClusterRouter:
    """See module docstring. Thread layout: the caller's submit path,
    one ``cluster-poll`` thread (outbox reaping + steal sweep), and the
    membership plane all share ``ClusterRouter._lock`` (the pending
    map + sequence counter) and the ring's own lock."""

    def __init__(self, root: str, engines, *, telemetry=None,
                 cost_model=None, budget_bytes: int | None = None,
                 steal: bool = False, steal_threshold: int = 4,
                 vnodes: int = 64, poll_s: float = 0.005,
                 bucket_sizes=None, horizon_quantum: int | None = None,
                 id_prefix: str = "c"):
        if steal_threshold < 1:
            raise ValueError(f"steal_threshold must be >= 1, "
                             f"got {steal_threshold}")
        self.root = os.path.abspath(root)
        self.telemetry = telemetry
        self.cost_model = cost_model
        self.budget_bytes = budget_bytes
        self.steal_enabled = steal
        self.steal_threshold = steal_threshold
        self.poll_s = poll_s
        self.bucket_sizes = (tuple(bucket_sizes) if bucket_sizes
                             else _buckets.DEFAULT_BUCKET_SIZES)
        self.horizon_quantum = (horizon_quantum if horizon_quantum
                                else _buckets.DEFAULT_HORIZON_QUANTUM)
        self.id_prefix = id_prefix
        self.ring = HashRing(engines, vnodes=vnodes)
        self.dirs = {e: transport.EngineDirs(root, e) for e in engines}
        self.stolen = 0
        self.routed = 0
        self._routes: dict[str, _Route] = {}
        self._seq = 0
        self._lock = lockwitness.make_lock("ClusterRouter._lock")
        self._stop = lockwitness.make_event("ClusterRouter._stop")
        self._thread = None
        self._running = False

    # ------------------------------------------------------ lifecycle --

    def start(self) -> "ClusterRouter":
        import threading

        with self._lock:
            if self._running:
                return self
            self._stop.clear()
            self._running = True
            t = threading.Thread(target=self._poll_loop,
                                 name="cluster-poll", daemon=True)
            self._thread = t
        t.start()
        return self

    def stop(self, drain: bool = True,
             drain_timeout_s: float = 300.0) -> None:
        if drain:
            deadline = time.monotonic() + drain_timeout_s
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._routes:
                        break
                time.sleep(self.poll_s)
        self._stop.set()
        with self._lock:
            self._running = False
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()      # outside _lock: the poll thread resolves under it

    def prewarm(self, cfgs) -> float:
        """Publish the shapes workers prewarm at boot
        (``<root>/prewarm.json``). Effective for workers that boot
        AFTER this call — the cluster harnesses write it before
        spawning engines; returns 0.0 (the boot pays the captures)."""
        from cbf_tpu_torch.durable.rollout import config_to_json

        transport.write_json_atomic(
            os.path.join(self.root, "prewarm.json"),
            [config_to_json(c) for c in cfgs])
        return 0.0

    # ------------------------------------------------------ admission --

    def submit(self, cfg, request_id: str | None = None,
               deadline_s: float | None = None,
               priority: str = "foreground"):
        """Admit, place and deposit one request; returns the
        :class:`RoutedPending` handle. Raises `ShedError` when the cost
        model prices the shape OVER the configured budget (fail-open
        for unpriced shapes / absent model, exactly `CostModel.fits`)."""
        key, _ = _buckets.bucket_key(cfg, sizes=self.bucket_sizes,
                                     horizon_quantum=self.horizon_quantum)
        label = key.label()
        predicted = 0
        if self.cost_model is not None:
            predicted = int(self.cost_model.predict_peak_bytes(key.n))
            if not self.cost_model.fits(key.n,
                                        budget_bytes=self.budget_bytes):
                raise resilience.ShedError(
                    f"cluster admission: bucket {label} predicted "
                    f"{predicted} bytes over budget "
                    f"{self.budget_bytes}", request_id=request_id,
                    bucket=label)
        engine = self.ring.place(label)
        from cbf_tpu_torch.durable.rollout import config_to_json

        with self._lock:
            self._seq += 1
            seq = self._seq
            rid = (request_id if request_id is not None
                   else f"{self.id_prefix}{seq}")
            if rid in self._routes:
                raise resilience.ServeError(
                    f"duplicate in-flight request id {rid!r}",
                    request_id=rid, bucket=label)
            pending = RoutedPending(rid, key)
            self._routes[rid] = _Route(pending, label, engine,
                                       time.perf_counter())
            self.routed += 1
        transport.write_request(self.dirs[engine], seq, rid, {
            "request_id": rid, "config": config_to_json(cfg),
            "bucket": label})
        if self.telemetry is not None:
            self.telemetry.event("cluster.route", {
                "request_id": rid, "bucket": label, "engine": engine,
                "inbox_depth": transport.inbox_depth(self.dirs[engine]),
                "predicted_bytes": predicted})
        return pending

    # ------------------------------------------------------ poll loop --

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.poll_once()

    def poll_once(self) -> int:
        """One reap + steal pass (public so tests and the membership
        plane can drive the router synchronously). Returns the number
        of responses reaped."""
        reaped = 0
        for engine in list(self.dirs):
            for path in transport.list_outbox(self.dirs[engine]):
                payload = transport.read_json(path)
                if payload is None:
                    continue
                try:
                    os.remove(path)
                except OSError:
                    continue     # someone else reaped it first
                self._resolve_payload(payload)
                reaped += 1
        if self.steal_enabled:
            self._steal_sweep()
        return reaped

    def _resolve_payload(self, payload: dict) -> None:
        rid = payload.get("request_id")
        with self._lock:
            route = self._routes.pop(rid, None)
        if route is None:
            return               # duplicate/late response: already done
        if not payload.get("ok"):
            route.pending._resolve(error=_error_from_payload(payload))
            return
        latency = time.perf_counter() - route.t_submit
        execute = float(payload.get("execute_s") or 0.0)
        route.pending._resolve(result=RoutedResult(
            request_id=rid, bucket=payload.get("bucket", route.label),
            n=int(payload.get("n") or 0),
            steps=int(payload.get("steps") or 0),
            engine=payload.get("engine"),
            latency_s=latency,
            queue_wait_s=max(0.0, latency - execute),
            execute_s=execute,
            batch_fill=int(payload.get("batch_fill") or 1),
            degraded=bool(payload.get("degraded")),
            ttfp_s=payload.get("ttfp_s"),
            outputs=_Outputs(
                float(payload.get("min_pairwise_distance",
                                  float("inf"))),
                int(payload.get("infeasible_count") or 0))))

    # -------------------------------------------------- work stealing --

    def _bucket_priced(self, label: str) -> bool:
        """Fail-open pricing check for steal targets: with a cost model
        armed, only relocate a bucket whose padded n has a measured
        peak (the engine can size it — it has seen, or shares the
        persistent cache of, that shape); without one, allow."""
        if self.cost_model is None:
            return True
        n = 0
        if label.startswith("n"):
            try:
                n = int(label[1:].split("-", 1)[0])
            except ValueError:
                return True
            return self.cost_model.predict_peak_bytes(n) > 0
        return True

    def _steal_sweep(self) -> int:
        """Relocate queued-but-UNCLAIMED requests from hotspotted
        inboxes to idle engines (see module docstring for why an acked
        request is unreachable here). Returns files moved."""
        live = self.ring.engines()
        depths = {e: transport.inbox_depth(self.dirs[e]) for e in live}
        idle = [e for e in live
                if depths[e] == 0
                and transport.claimed_depth(self.dirs[e]) == 0]
        if not idle:
            return 0
        moved = 0
        for engine in live:
            if depths[engine] < self.steal_threshold:
                continue
            for path in transport.list_inbox(self.dirs[engine]):
                if not idle:
                    break
                payload = transport.read_json(path)
                if payload is None:
                    continue
                label = payload.get("bucket", "")
                if not self._bucket_priced(label):
                    continue
                target = idle[0]
                new = transport.steal(self.dirs[engine],
                                      self.dirs[target], path)
                if new is None:
                    continue     # the worker's claim won the rename
                idle.pop(0)
                moved += 1
                rid = payload.get("request_id")
                with self._lock:
                    self.stolen += 1
                    route = self._routes.get(rid)
                    if route is not None:
                        route.engine = target
                if self.telemetry is not None:
                    self.telemetry.event("cluster.steal", {
                        "request_id": rid, "bucket": label,
                        "from_engine": engine, "to_engine": target,
                        "inbox_depth": depths[engine]})
        return moved

    # ------------------------------------------- failover / roll seams --

    def routes_on(self, engine: str) -> list[str]:
        """Request ids currently routed to ``engine`` (unresolved)."""
        with self._lock:
            return [rid for rid, r in self._routes.items()
                    if r.engine == engine]

    def reroute_file(self, from_engine: str, path: str) -> str | None:
        """Relocate one UNCLAIMED inbox file off ``from_engine`` onto
        its ring placement among the survivors (the engine must already
        be out of the ring). Legal for the same reason stealing is: an
        inbox file is unacked by construction (and so is a claimed file
        the dead engine's journal never acknowledged, once its epoch is
        fenced: `cluster.membership` re-routes those too)."""
        payload = transport.read_json(path)
        if payload is None:
            return None
        target = self.ring.place(payload.get("bucket", ""))
        new = transport.steal(self.dirs[from_engine], self.dirs[target],
                              path)
        if new is not None:
            rid = payload.get("request_id")
            with self._lock:
                route = self._routes.get(rid)
                if route is not None:
                    route.engine = target
        return new

    def resubmit(self, rid: str, config_json: dict, label: str) -> str:
        """Re-deposit a dead engine's acknowledged-but-unresolved
        request (from its journal replay) onto a survivor. The pending
        handle, when the router still holds one, is reused — the client
        never observes the failover."""
        target = self.ring.place(label)
        with self._lock:
            self._seq += 1
            seq = self._seq
            route = self._routes.get(rid)
            if route is not None:
                route.engine = target
        transport.write_request(self.dirs[target], seq, rid, {
            "request_id": rid, "config": config_json, "bucket": label})
        return target

    def synthesize(self, rid: str, label: str) -> bool:
        """Resolve a pending whose worker died AFTER the WAL ``resolved``
        fsync but BEFORE the response file landed: the outcome is
        durable and deduped (re-running it would be a duplicate
        execution), so the router completes the handle from the journal
        evidence. Returns False when no pending is held for ``rid``."""
        with self._lock:
            route = self._routes.pop(rid, None)
        if route is None:
            return False
        latency = time.perf_counter() - route.t_submit
        route.pending._resolve(result=RoutedResult(
            request_id=rid, bucket=label, n=0, steps=0, engine=None,
            latency_s=latency, queue_wait_s=latency, execute_s=0.0,
            batch_fill=1, degraded=False, ttfp_s=None,
            outputs=_Outputs(float("inf"), 0)))
        return True
