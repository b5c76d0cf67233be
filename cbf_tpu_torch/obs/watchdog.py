"""Host-side watchdog: turn the heartbeat stream into structured alerts
(counterpart: cbf_tpu/obs/watchdog.py).

Consumes a :class:`~cbf_tpu_torch.obs.sink.TelemetrySink`'s events
synchronously (a subscriber callback, O(fields) per heartbeat) plus one
optional thread for the only check that needs wall-clock initiative: stall
detection (a wedged run emits nothing, so no event can trigger it).

Alert classes, each trippable through ``utils.faults``:

- ``nan`` — a heartbeat channel non-finite, or a positive
  ``nonfinite_state_count`` (``faults.nan_at_step`` / ``inf_at_step``);
- ``certificate_blowup`` — certificate_residual above
  ``residual_threshold`` (``faults.residual_blowup_at_step`` on the warm
  certificate, or ``corrupt_output_at_step`` on the record);
- ``sustained_infeasibility`` — infeasible_count > 0 for
  ``infeasible_patience`` consecutive heartbeats;
- ``stall`` — no heartbeat for ``stall_timeout`` seconds while the run is
  live (``faults.stall_at_step`` holds the host before the chunk that
  holds its step);
- ``slo_burn`` and ``sustained_low_occupancy`` — the serving layer's
  queue-wait and lane-occupancy objectives (``SLOTargets``), fed by the
  serve engine's ``request`` events (its drain mode) and the lane
  ledger's ``serve.lanes.window`` (continuous mode, Queue A11).

Alerts are appended to the run's JSONL stream, collected in
``Watchdog.alerts`` and forwarded to ``on_alert``. Edge-triggered: each
class re-arms only after a healthy heartbeat. While the heartbeat carries
``rta_mode > 0`` the certificate and infeasibility alerts are the RTA
ladder absorbing the fault and are downgraded to ``severity="warning"``;
``nan`` alerts stay critical.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, NamedTuple

from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.obs import schema
from cbf_tpu_torch.obs.sink import TelemetrySink

ALERT_NAN = "nan"
ALERT_CERT_BLOWUP = "certificate_blowup"
ALERT_INFEASIBLE = "sustained_infeasibility"
ALERT_STALL = "stall"
ALERT_SLO_BURN = "slo_burn"
ALERT_LOW_OCCUPANCY = "sustained_low_occupancy"

ALERT_KINDS = (ALERT_NAN, ALERT_CERT_BLOWUP, ALERT_INFEASIBLE, ALERT_STALL,
               ALERT_SLO_BURN, ALERT_LOW_OCCUPANCY)


class SLOTargets(NamedTuple):
    """Serving SLO targets for the burn-rate checks (pass to
    ``Watchdog(slo=...)``; both checks are off with the default None
    targets).

    ``queue_wait_p99_s`` — the queue-wait objective: a request waiting
    longer is an SLO-bad event. ``error_budget`` — allowed bad-request
    fraction (0.01 = 99% of requests in target). ``occupancy_pct`` —
    minimum acceptable ledger occupancy (busy / lane-time, percent).
    ``fast_window_s``/``slow_window_s`` — the two burn windows;
    ``fast_burn``/``slow_burn`` — burn-rate thresholds that must BOTH be
    exceeded (Google SRE's 14.4x/2h + 6x/... pairing collapsed to our
    1 min / 10 min horizons). ``min_requests`` — fast-window sample
    floor before slo_burn may trip (no paging off two requests).
    """
    queue_wait_p99_s: float | None = None
    error_budget: float = 0.01
    occupancy_pct: float | None = None
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn: float = 14.0
    slow_burn: float = 2.0
    min_requests: int = 10


class Alert(NamedTuple):
    kind: str
    step: int | None
    detail: str
    t_wall: float
    severity: str = "critical"
    # rta_mode gauge from the triggering heartbeat (None when the run has
    # no RTA channel or the alert is host-side, e.g. stall).
    rta_mode: float | None = None


class Watchdog:
    """Subscribe to ``sink`` and raise structured alerts on its stream.

    ``stall_timeout=None`` (default) disables the stall thread — the three
    event-driven checks still run. Use as a context manager or call
    ``stop()``; the stall thread is a daemon either way.
    """

    def __init__(self, sink: TelemetrySink, *,
                 residual_threshold: float = 1e-2,
                 infeasible_patience: int = 3,
                 stall_timeout: float | None = None,
                 on_alert: Callable[[Alert], None] | None = None,
                 slo: SLOTargets | None = None):
        if infeasible_patience < 1:
            raise ValueError(
                f"infeasible_patience must be >= 1, got {infeasible_patience}")
        self.sink = sink
        self.residual_threshold = float(residual_threshold)
        self.infeasible_patience = int(infeasible_patience)
        self.stall_timeout = stall_timeout
        self.on_alert = on_alert
        self.slo = slo
        self.alerts: list[Alert] = []
        self._lock = lockwitness.make_lock("Watchdog._lock")
        self._infeasible_streak = 0
        self._armed = {ALERT_NAN: True, ALERT_CERT_BLOWUP: True,
                       ALERT_INFEASIBLE: True, ALERT_SLO_BURN: True,
                       ALERT_LOW_OCCUPANCY: True}
        # Burn-rate sample windows: (t_wall, bad) per request event and
        # (t_wall, occupancy_pct) per serve.lanes.window event, evicted
        # past the slow window. The sink fans subscriber callbacks out
        # AFTER releasing its own lock, so two emitting threads can run
        # _on_event concurrently — all check state (_armed, streaks,
        # these windows) mutates under self._lock, with alerts raised
        # after release (_raise_alert re-takes the same lock).
        self._slo_requests: collections.deque = collections.deque()
        self._occ_samples: collections.deque = collections.deque()
        self._stop = lockwitness.make_event("Watchdog._stop")
        self._started = time.time()
        self._thread = None
        sink.subscribe(self._on_event)
        if stall_timeout is not None:
            if stall_timeout <= 0:
                raise ValueError(
                    f"stall_timeout must be > 0, got {stall_timeout}")
            self._thread = threading.Thread(target=self._stall_loop,
                                            daemon=True)
            self._thread.start()

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        self.sink.unsubscribe(self._on_event)
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- checks ------------------------------------------------------------

    def _raise_alert(self, kind: str, step: int | None, detail: str, *,
                     severity: str = "critical",
                     rta_mode: float | None = None) -> None:
        alert = Alert(kind, step, detail, time.time(),
                      severity=severity, rta_mode=rta_mode)
        with self._lock:
            self.alerts.append(alert)
        self.sink.alert(kind, step=step, detail=detail, severity=severity,
                        rta_mode=rta_mode)
        if self.on_alert is not None:
            try:
                self.on_alert(alert)
            except Exception:
                pass

    def _on_event(self, event: dict) -> None:
        etype = event.get("event")
        if etype == "request":
            if self.slo is not None \
                    and self.slo.queue_wait_p99_s is not None:
                self._check_slo_burn(event)
            return
        if etype == "serve.lanes.window":
            if self.slo is not None and self.slo.occupancy_pct is not None:
                self._check_occupancy(event)
            return
        if etype != "heartbeat":
            return
        step = event.get("step")
        values = {f.name: schema.scalar_value(event[f.name])
                  for f in schema.HEARTBEAT_FIELDS if f.name in event}
        rta = values.get("rta_mode")
        # NaN-safe: a poisoned rta_mode channel must NOT be treated as an
        # engaged ladder (that would downgrade a real critical alert).
        absorbed = rta is not None and rta == rta and rta > 0

        bad = sorted(n for n, v in values.items()
                     if v != v or abs(v) == float("inf"))
        # The tap's dedicated corruption counter: min/max reductions may
        # swallow NaN, so a NaN-corrupted state shows up as a positive
        # count here rather than a non-finite metric value.
        nsc = values.get("nonfinite_state_count")
        if nsc is not None and nsc == nsc and nsc > 0:
            bad.append(f"nonfinite_state_count={int(nsc)}")
        raises: list[tuple[str, str, str]] = []
        with self._lock:
            if bad:
                if self._armed[ALERT_NAN]:
                    self._armed[ALERT_NAN] = False
                    # Stays critical even while the ladder is engaged: a
                    # non-finite value on the stream escaped the ladder.
                    raises.append((
                        ALERT_NAN,
                        f"non-finite heartbeat channel(s): "
                        f"{', '.join(bad)}", "critical"))
            else:
                self._armed[ALERT_NAN] = True

            res = values.get("certificate_residual")
            if res is not None:
                if res == res and res > self.residual_threshold:
                    if self._armed[ALERT_CERT_BLOWUP]:
                        self._armed[ALERT_CERT_BLOWUP] = False
                        detail = (f"certificate residual {res:.3e} > "
                                  f"threshold {self.residual_threshold:.1e}")
                        if absorbed:
                            detail += f" (absorbed by RTA rung {int(rta)})"
                        raises.append((
                            ALERT_CERT_BLOWUP, detail,
                            "warning" if absorbed else "critical"))
                else:
                    self._armed[ALERT_CERT_BLOWUP] = True

            inf = values.get("infeasible_count")
            if inf is not None:
                if inf == inf and inf > 0:
                    self._infeasible_streak += 1
                    if (self._infeasible_streak >= self.infeasible_patience
                            and self._armed[ALERT_INFEASIBLE]):
                        self._armed[ALERT_INFEASIBLE] = False
                        detail = (f"infeasible QPs on "
                                  f"{self._infeasible_streak} consecutive "
                                  f"heartbeats (last count {int(inf)})")
                        if absorbed:
                            detail += f" (absorbed by RTA rung {int(rta)})"
                        raises.append((
                            ALERT_INFEASIBLE, detail,
                            "warning" if absorbed else "critical"))
                else:
                    self._infeasible_streak = 0
                    self._armed[ALERT_INFEASIBLE] = True
        for kind, detail, severity in raises:
            self._raise_alert(kind, step, detail, severity=severity,
                              rta_mode=rta)

    def _check_slo_burn(self, event: dict) -> None:
        """Multi-window error-budget burn on queue wait. Burn rate =
        (bad-request fraction in window) / error_budget; trips only when
        the FAST and SLOW windows both exceed their thresholds, re-arms
        once the fast window drops back under 1x (budget no longer
        burning)."""
        slo = self.slo
        try:
            wait = schema.scalar_value(event.get("queue_wait_s"))
        except (TypeError, ValueError):
            return
        now = float(event.get("t_wall") or time.time())
        bad = wait == wait and wait > slo.queue_wait_p99_s
        trip = False
        with self._lock:
            q = self._slo_requests
            q.append((now, bad))
            while q and q[0][0] < now - slo.slow_window_s:
                q.popleft()
            fast = [b for t, b in q if t >= now - slo.fast_window_s]
            if len(fast) < slo.min_requests:
                return
            budget = max(slo.error_budget, 1e-9)
            fast_burn = (sum(fast) / len(fast)) / budget
            slow_burn = (sum(b for _, b in q) / len(q)) / budget
            if fast_burn >= slo.fast_burn and slow_burn >= slo.slow_burn:
                if self._armed[ALERT_SLO_BURN]:
                    self._armed[ALERT_SLO_BURN] = False
                    trip = True
            elif fast_burn < 1.0:
                self._armed[ALERT_SLO_BURN] = True
        if trip:
            self._raise_alert(
                ALERT_SLO_BURN, None,
                f"queue-wait SLO burning {fast_burn:.1f}x budget over "
                f"{slo.fast_window_s:.0f}s and {slow_burn:.1f}x over "
                f"{slo.slow_window_s:.0f}s (target "
                f"{slo.queue_wait_p99_s:.3f}s, budget "
                f"{slo.error_budget:.3f})")

    def _check_occupancy(self, event: dict) -> None:
        """Sustained-low-occupancy: every fast-window ledger sample
        (>= 2) AND at least half the slow-window samples below target.
        Re-arms on the first healthy sample."""
        slo = self.slo
        try:
            occ = schema.scalar_value(event.get("occupancy_pct"))
        except (TypeError, ValueError):
            return
        if occ != occ:
            return
        now = float(event.get("t_wall") or time.time())
        trip = False
        with self._lock:
            q = self._occ_samples
            q.append((now, occ))
            while q and q[0][0] < now - slo.slow_window_s:
                q.popleft()
            if occ >= slo.occupancy_pct:
                self._armed[ALERT_LOW_OCCUPANCY] = True
                return
            fast = [o for t, o in q if t >= now - slo.fast_window_s]
            slow_low = sum(o < slo.occupancy_pct for _, o in q)
            if (len(fast) >= 2
                    and all(o < slo.occupancy_pct for o in fast)
                    and slow_low * 2 >= len(q)
                    and self._armed[ALERT_LOW_OCCUPANCY]):
                self._armed[ALERT_LOW_OCCUPANCY] = False
                trip = True
        if trip:
            self._raise_alert(
                ALERT_LOW_OCCUPANCY, None,
                f"lane occupancy {occ:.1f}% below target "
                f"{slo.occupancy_pct:.1f}% across the last "
                f"{len(fast)} ledger windows "
                f"({slow_low}/{len(q)} slow-window samples low)",
                severity="warning")

    def _stall_loop(self) -> None:
        # Re-arming: one alert per stall episode; a fresh heartbeat after
        # the alert re-arms the detector.
        alerted_at: float | None = None
        while not self._stop.wait(min(self.stall_timeout / 4, 1.0)):
            last = self.sink.last_heartbeat_wall
            ref = last if last is not None else self._started
            age = time.time() - ref
            if age <= self.stall_timeout:
                alerted_at = None
                continue
            if alerted_at is not None and (last or 0.0) <= alerted_at:
                continue
            alerted_at = ref
            what = ("no heartbeat yet" if last is None
                    else "heartbeats stopped")
            self._raise_alert(
                ALERT_STALL, None,
                f"{what}: {age:.1f}s silent > stall_timeout="
                f"{self.stall_timeout:.1f}s")
