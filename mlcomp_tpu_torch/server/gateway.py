"""Routing gateway — the fleet's front door (port of
``mlcomp_tpu/server/gateway.py``; stdlib only, so the gateway process
holds no CUDA context).

``serve.py`` is one process serving one card; the fleet tier
(server/fleet.py) runs N such replicas per model as supervisor-
scheduled tasks. This module is the piece clients actually talk to:
one HTTP endpoint that proxies ``POST /predict[/<fleet>]`` to healthy
replicas and absorbs the fleet's failure modes so they never become a
client's problem:

- **health-gated routing** — round-robin over the ACTIVE generation's
  healthy replicas, each behind a per-replica circuit breaker
  (closed → open after N consecutive failures → half-open probe after
  a cooldown → closed on success). An open breaker takes a replica out
  of rotation without waiting for the supervisor's slower probe loop.
- **hedged retry** — an idempotent predict that fails on one replica
  (connection error, 5xx, replica 429 backpressure) is retried ONCE on
  a different replica, under a token-bucket hedge budget (a fraction
  of traffic) so a sick fleet degrades into errors instead of a
  retry storm that doubles its own load.
- **SLO-keyed load shedding** — per-fleet rolling p99 over the
  gateway-observed latencies; above the fleet's ``slo_p99_ms`` new
  requests shed with ``429 Retry-After`` until the pool catches up.
  A per-fleet in-flight bound (``max_pending``) backstops it. Health
  probes (``GET /health``, ``/metrics``, anything with the
  ``X-MLComp-Probe`` header) are NEVER shed — shedding the prober
  would turn overload into a false death verdict.
- **zero-downtime swap** — the router reads the fleet's active
  generation from the DB (refresh thread); when the reconciler flips
  generation N→N+1 the backend set swaps wholesale while in-flight
  requests to generation N finish behind ``serve.py``'s drain.

The routing tables come from ``refresh_from_db`` (production) or
``set_fleet`` (tests/bench) — the proxy logic is identical, which is
what makes the router's failure handling unit-testable against stub
backends with no supervisor running.
"""

import http.client
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

from mlcomp_tpu_torch import TOKEN
# TRACE_HEADER: stamped on every proxied upstream request (and honored
# when a client supplies its own) — serve.py reads it back, so a
# serving request's gateway hop and replica handling assemble into one
# ``GET /telemetry/trace/<id>`` tree like the DAG/worker path
from mlcomp_tpu_torch.server.serve import LATENCY_BUCKETS_MS, TRACE_HEADER

#: header that marks a request as a health probe — never shed
PROBE_HEADER = 'X-MLComp-Probe'


class CircuitBreaker:
    """Per-replica circuit breaker: closed / open / half-open.

    ``allow()`` answers "may I send a request to this replica now?" —
    in half-open exactly ONE trial is admitted at a time; its outcome
    (``record_success``/``record_failure``) closes or re-opens the
    circuit. All transitions are under one lock: the gateway is
    thread-per-request."""

    def __init__(self, failure_threshold: int = 3,
                 cooldown_s: float = 10.0, clock=time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.lock = threading.Lock()
        self.state = 'closed'
        self.failures = 0
        self.opened_at = None
        self._trial_inflight = False

    def allow(self) -> bool:
        with self.lock:
            if self.state == 'closed':
                return True
            if self.state == 'open':
                if self.clock() - self.opened_at >= self.cooldown_s:
                    self.state = 'half_open'
                    self._trial_inflight = True
                    return True
                return False
            # half-open: one live trial owns the verdict
            if self._trial_inflight:
                return False
            self._trial_inflight = True
            return True

    def record_success(self):
        with self.lock:
            self.state = 'closed'
            self.failures = 0
            self.opened_at = None
            self._trial_inflight = False

    def record_failure(self):
        with self.lock:
            self._trial_inflight = False
            if self.state == 'half_open':
                self.state = 'open'          # trial failed: back off
                self.opened_at = self.clock()
                return
            self.failures += 1
            if self.state == 'closed' and \
                    self.failures >= self.failure_threshold:
                self.state = 'open'
                self.opened_at = self.clock()

    def release_trial(self):
        """Resolve an admitted request with NO health verdict (a 429:
        the replica is alive but busy — neither confirmation nor
        breakage). Without this, a half-open trial that drew a 429
        would pin ``_trial_inflight`` forever and lock the replica out
        of rotation for good."""
        with self.lock:
            self._trial_inflight = False


class HedgeBudget:
    """Token bucket bounding hedged retries to a fraction of traffic.

    Every proxied request earns ``ratio`` tokens (capped at ``burst``);
    a hedge spends one. Under a fleet-wide outage the budget drains and
    requests fail fast instead of doubling the load — the classic
    retry-storm guard ("The Tail at Scale" hedging, bounded)."""

    def __init__(self, ratio: float = 0.1, burst: float = 5.0):
        self.ratio = float(ratio)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.lock = threading.Lock()

    def note_request(self):
        with self.lock:
            self.tokens = min(self.burst, self.tokens + self.ratio)

    def try_spend(self) -> bool:
        with self.lock:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False

    def refund(self):
        """Return a spent token that bought nothing (no second
        replica existed to hedge onto)."""
        with self.lock:
            self.tokens = min(self.burst, self.tokens + 1.0)


class RollingSlo:
    """Rolling p99 over the last ``window`` gateway-observed latencies.
    ``over_slo()`` is the shed signal; it needs ``min_samples`` before
    it ever fires (an empty window must not shed the first request of
    the day).

    The window is TIME-bounded too (``max_age_s``): samples expire.
    Without expiry, a fully-shedding fleet observes nothing new, the
    poisoned window holds its p99 forever, and shedding never releases
    — the 100%-shed deadlock. With it, a quiet (fully shed) window
    drains and admission resumes as a probe of recovery; under real
    sustained overload the re-admitted requests re-trip the SLO, which
    is the intended oscillation of a naive shedder."""

    def __init__(self, slo_p99_ms: float, window: int = 256,
                 min_samples: int = 30, max_age_s: float = 10.0,
                 clock=time.monotonic):
        self.slo_p99_ms = float(slo_p99_ms) if slo_p99_ms else None
        self.window = deque(maxlen=int(window))
        self.min_samples = int(min_samples)
        self.max_age_s = float(max_age_s)
        self.clock = clock
        self.lock = threading.Lock()

    def _prune(self, now):
        horizon = now - self.max_age_s
        while self.window and self.window[0][0] < horizon:
            self.window.popleft()

    def observe(self, ms: float):
        with self.lock:
            now = self.clock()
            self._prune(now)
            self.window.append((now, float(ms)))

    def p99(self):
        with self.lock:
            self._prune(self.clock())
            if len(self.window) < self.min_samples:
                return None
            data = sorted(ms for _, ms in self.window)
        idx = min(len(data) - 1, int(0.99 * (len(data) - 1) + 0.9999))
        return data[idx]

    def over_slo(self) -> bool:
        if self.slo_p99_ms is None:
            return False
        p99 = self.p99()
        return p99 is not None and p99 > self.slo_p99_ms


class _Backend:
    """One routed replica endpoint: circuit breaker + a small pool of
    persistent HTTP/1.1 connections. Per-request TCP setup doubles the
    proxy's latency and collapses its throughput under concurrency —
    a connection that served a keep-alive response goes back to the
    pool; one that errored (or whose response closes) is discarded."""

    POOL_MAX = 8

    def __init__(self, url: str, replica_id=None, breaker_kw=None):
        self.url = url.rstrip('/')
        parts = urlsplit(self.url)
        self.host = parts.hostname or '127.0.0.1'
        self.hport = parts.port or 80
        self.replica_id = replica_id
        self.breaker = CircuitBreaker(**(breaker_kw or {}))
        self.requests = 0
        self.errors = 0
        self._pool = []
        self._pool_lock = threading.Lock()

    def acquire(self, timeout: float):
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return http.client.HTTPConnection(self.host, self.hport,
                                          timeout=timeout)

    def release(self, conn, reusable: bool):
        if reusable:
            with self._pool_lock:
                if len(self._pool) < self.POOL_MAX:
                    self._pool.append(conn)
                    return
        try:
            conn.close()
        except Exception:
            pass

    def close_pool(self):
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for conn in pool:
            try:
                conn.close()
            except Exception:
                pass


class _FleetRoute:
    """Routing state for one fleet: generation, backends, SLO window,
    counters. Backends are replaced wholesale on refresh; a backend
    whose URL persists keeps its breaker (an open circuit must survive
    a refresh, or every refresh would amnesty a sick replica)."""

    def __init__(self, name: str, slo_p99_ms=None, max_pending: int = 256,
                 hedge_ratio: float = 0.1, breaker_kw=None):
        self.name = name
        self.generation = 0
        self.backends = []
        self.breaker_kw = breaker_kw or {}
        self.slo = RollingSlo(slo_p99_ms)
        self.max_pending = int(max_pending)
        self.hedge = HedgeBudget(ratio=hedge_ratio)
        self.lock = threading.Lock()
        self._rr = 0
        self.inflight = 0
        self.requests = 0
        self.ok = 0
        self.shed = 0
        self.hedges = 0
        self.failovers = 0
        self.errors = 0

    def set_backends(self, generation: int, urls_with_ids):
        """urls_with_ids: [(url, replica_id)] — the new ACTIVE set."""
        with self.lock:
            old = {b.url: b for b in self.backends}
            fresh = []
            for url, rid in urls_with_ids:
                kept = old.pop(url.rstrip('/'), None)
                if kept is not None and self.generation == generation:
                    kept.replica_id = rid
                    fresh.append(kept)
                else:
                    if kept is not None:
                        old[kept.url] = kept    # retired: close below
                    fresh.append(_Backend(url, rid, self.breaker_kw))
            self.backends = fresh
            self.generation = int(generation)
        for dropped in old.values():
            dropped.close_pool()

    def admit(self, probe: bool = False) -> bool:
        """Atomic admission: the in-flight check and the increment
        happen under ONE lock hold. The earlier shape — check
        ``inflight >= max_pending`` outside the lock, then increment
        under it — let a concurrent burst pass the check together and
        overshoot ``max_pending`` (the check-then-act race the
        concurrency lint now flags as cc-lockset). Probes are counted
        but never shed. Returns False when the request must shed."""
        over_slo = (not probe) and self.slo.over_slo()
        with self.lock:
            self.requests += 1
            if probe:
                self.inflight += 1
                return True
            if over_slo or self.inflight >= self.max_pending:
                self.shed += 1
                return False
            self.inflight += 1
            return True

    def release(self):
        with self.lock:
            self.inflight -= 1

    def pick(self, exclude=None):
        """Next circuit-admitted backend in round-robin order, skipping
        ``exclude`` (the backend a hedge is retrying away from)."""
        with self.lock:
            n = len(self.backends)
            for i in range(n):
                b = self.backends[(self._rr + i) % n] if n else None
                if b is None or b is exclude:
                    continue
                if b.breaker.allow():
                    self._rr = (self._rr + i + 1) % n
                    return b
            return None

    def snapshot(self):
        with self.lock:
            backends = [{'url': b.url, 'replica': b.replica_id,
                         'circuit': b.breaker.state,
                         'requests': b.requests, 'errors': b.errors}
                        for b in self.backends]
        return {'generation': self.generation,
                'backends': backends,
                'p99_ms': self.slo.p99(),
                'slo_p99_ms': self.slo.slo_p99_ms,
                'max_pending': self.max_pending,
                'inflight': self.inflight,
                'requests': self.requests, 'ok': self.ok,
                'shed': self.shed, 'hedges': self.hedges,
                'failovers': self.failovers, 'errors': self.errors}


class _ReplicaReply(Exception):
    """A replica answered with a non-2xx status — carries it through
    the proxy path so the LAST replica's verdict reaches the client."""

    def __init__(self, status: int, body: bytes):
        super().__init__(f'replica status {status}')
        self.status = status
        self.body = body


class FleetGateway:
    """One process clients point at; N replicas behind it."""

    def __init__(self, host: str = '127.0.0.1', port: int = 4300,
                 token: str = None, session=None, refresh_s: float = 2.0,
                 request_timeout_s: float = 30.0, hedge_ratio: float = 0.1,
                 breaker_kw: dict = None):
        self.host, self.port = host, port
        self.token = TOKEN if token is None else token
        self.session = session
        self.refresh_s = float(refresh_s)
        self.request_timeout_s = float(request_timeout_s)
        self.hedge_ratio = float(hedge_ratio)
        self.breaker_kw = breaker_kw or {}
        self.routes = {}
        self.routes_lock = threading.Lock()
        self.httpd = None
        self._draining = False
        self._refresh_stop = threading.Event()
        self._refresh_thread = None
        self._lifecycle = threading.Lock()
        self._serving = False
        self._closed = False
        # latency histograms ride the same cumulative-bucket recorder
        # as serve.py, so the heartbeat flush re-exports through the
        # API server's /metrics with real histogram semantics
        from mlcomp_tpu_torch.telemetry import MetricRecorder
        self.telemetry = MetricRecorder(component='gateway',
                                        flush_every=10 ** 9)

    # ---------------------------------------------------------- routing
    def route(self, name: str) -> _FleetRoute:
        with self.routes_lock:
            return self.routes.get(name)

    def set_fleet(self, name: str, generation: int, backends,
                  slo_p99_ms=None, max_pending: int = None):
        """Install/update one fleet's routing table. ``backends``:
        list of urls or (url, replica_id) pairs."""
        pairs = [(b, None) if isinstance(b, str) else tuple(b)
                 for b in backends]
        with self.routes_lock:
            route = self.routes.get(name)
            if route is None:
                route = _FleetRoute(
                    name, slo_p99_ms=slo_p99_ms,
                    max_pending=max_pending or 256,
                    hedge_ratio=self.hedge_ratio,
                    breaker_kw=self.breaker_kw)
                self.routes[name] = route
        if slo_p99_ms is not None:
            route.slo.slo_p99_ms = float(slo_p99_ms)
        if max_pending is not None:
            route.max_pending = int(max_pending)
        route.set_backends(generation, pairs)
        return route

    def refresh_from_db(self, session=None):
        """Pull the ACTIVE generation's healthy replicas per fleet from
        the DB — the production routing source, driven by the refresh
        thread. Routes for stopped/removed fleets are dropped."""
        session = session or self.session
        if session is None:
            return
        from mlcomp_tpu_torch.db.providers.fleet import (
            FleetProvider, ReplicaProvider,
        )
        fleets = FleetProvider(session).active()
        rp = ReplicaProvider(session)
        seen = set()
        for fleet in fleets:
            seen.add(fleet.name)
            healthy = rp.of_fleet(fleet.id, generation=fleet.generation,
                                  states=('healthy',))
            self.set_fleet(
                fleet.name, fleet.generation,
                [(r.url, r.id) for r in healthy if r.url],
                slo_p99_ms=fleet.slo_p99_ms,
                max_pending=fleet.max_pending)
        with self.routes_lock:
            for name in list(self.routes):
                if name not in seen:
                    del self.routes[name]

    def _refresh_loop(self):
        while not self._refresh_stop.wait(self.refresh_s):
            try:
                self.refresh_from_db()
            except Exception:
                pass            # a DB hiccup must not stop routing

    def start_refresh(self):
        if self.session is None or self._refresh_thread is not None:
            return
        self.refresh_from_db()
        self._refresh_thread = threading.Thread(
            target=self._refresh_loop, daemon=True)
        self._refresh_thread.start()

    # ------------------------------------------------------------ proxy
    def _forward(self, backend: _Backend, path: str, body: bytes,
                 timeout: float, trace_id: str = None):
        """POST over a pooled persistent connection. Returns
        (status, payload) for EVERY HTTP status — unlike urllib,
        http.client does not raise on 4xx/5xx, so the caller sees the
        replica's verdict directly; only transport failures raise."""
        conn = backend.acquire(timeout)
        reusable = False
        headers = {'Authorization': self.token,
                   'Content-Type': 'application/json'}
        if trace_id:
            headers[TRACE_HEADER] = trace_id
        try:
            conn.request('POST', path, body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            reusable = not resp.will_close
            return resp.status, payload
        finally:
            backend.release(conn, reusable)

    def proxy_predict(self, name: str, body: bytes, probe: bool = False,
                      trace_id: str = None):
        """The full admission + routing + hedge path for one request.
        Returns (status, payload_bytes). Separated from the HTTP
        handler so tests and the bench drive it directly.

        Every admitted request gets a trace id (the caller's, or one
        minted here), stamped on the upstream hop (``X-MLComp-Trace``,
        read back by serve.py) and recorded as a ``role='gateway'``
        span — the serving path's entry into the cross-process trace
        forest."""
        route = self.route(name)
        if route is None:
            return 404, json.dumps(
                {'error': f'no fleet {name!r}',
                 'fleets': sorted(self.routes)}).encode()
        route.hedge.note_request()
        # SLO-keyed shedding + the in-flight backstop — probes exempt.
        # Admission is one atomic check-and-increment (route.admit):
        # a shed verdict and an admit must never interleave between
        # the check and the count, or bursts overshoot max_pending.
        if not route.admit(probe=probe):
            self.telemetry.count(f'fleet.{name}.shed')
            return 429, json.dumps(
                {'error': 'shedding load — rolling p99 over SLO '
                          'or queue full', 'retry_after_s': 1}).encode()
        from mlcomp_tpu_torch.telemetry.spans import new_trace_id, record_span
        trace_id = trace_id or new_trace_id()
        started = time.time()
        t0 = time.monotonic()
        status = None
        try:
            status, payload = self._proxy_with_hedge(
                route, name, body, trace_id=trace_id)
            return status, payload
        finally:
            route.release()
            ms = (time.monotonic() - t0) * 1e3
            route.slo.observe(ms)
            self.telemetry.observe(f'fleet.{name}.latency_ms', ms,
                                   buckets=LATENCY_BUCKETS_MS)
            record_span(
                'gateway.predict', started, ms / 1e3,
                tags={'fleet': name,
                      'status': status if status is not None else 'exc'},
                status='ok' if status is not None and status < 500
                else 'error',
                trace_id=trace_id, role='gateway')

    def _proxy_with_hedge(self, route: _FleetRoute, name: str,
                          body: bytes, trace_id: str = None):
        first = route.pick()
        if first is None:
            with route.lock:
                route.errors += 1
            return 503, json.dumps(
                {'error': f'no healthy replica for {name!r}',
                 'retry_after_s': 1}).encode()
        try:
            return self._attempt(route, first, body, trace_id=trace_id)
        except (_ReplicaReply, http.client.HTTPException,
                OSError) as exc:
            # predicts are idempotent: one hedged retry on a DIFFERENT
            # replica, if the budget allows and one exists. The budget
            # is checked BEFORE pick(): allow() on a half-open backend
            # claims its single trial slot, and claiming one we then
            # decline to use would leak the trial and lock the backend
            # out of rotation. A replica 429 (its own admission bound)
            # is retryable but NOT a circuit failure.
            second = None
            if route.hedge.try_spend():
                second = route.pick(exclude=first)
                if second is None:
                    route.hedge.refund()    # token bought nothing
            if second is not None:
                with route.lock:
                    route.hedges += 1
                try:
                    result = self._attempt(route, second, body,
                                           trace_id=trace_id)
                    with route.lock:
                        route.failovers += 1
                    return result
                except (_ReplicaReply, http.client.HTTPException,
                        OSError) as e2:
                    exc = e2
            with route.lock:
                route.errors += 1
            if isinstance(exc, _ReplicaReply):
                return exc.status, exc.body
            return 502, json.dumps(
                {'error': f'replica unreachable: {exc}'}).encode()

    def _attempt(self, route: _FleetRoute, backend: _Backend,
                 body: bytes, trace_id: str = None):
        with route.lock:
            backend.requests += 1
        try:
            status, payload = self._forward(
                backend, '/predict', body, self.request_timeout_s,
                trace_id=trace_id)
        except (http.client.HTTPException, OSError):
            with route.lock:
                backend.errors += 1
            backend.breaker.record_failure()
            raise
        if status == 429:
            # backpressure, not sickness: retryable elsewhere but no
            # breaker penalty — the replica is healthy, just busy.
            # The trial slot a half-open allow() may have claimed is
            # released without a verdict, or it would leak forever.
            backend.breaker.release_trial()
            with route.lock:
                backend.errors += 1
            raise _ReplicaReply(status, payload)
        if status >= 500:
            with route.lock:
                backend.errors += 1
            backend.breaker.record_failure()
            raise _ReplicaReply(status, payload)
        # other 4xx = the CLIENT's fault (bad body, bad auth): the
        # other replica would say the same — no hedge, no penalty
        backend.breaker.record_success()
        if 200 <= status < 300:
            with route.lock:
                route.ok += 1
        return status, payload

    # ------------------------------------------------------------- http
    def _handler(self):
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: every response carries Content-Length, so
            # clients that reuse their connection skip the TCP setup
            # the backend pool already skips on the replica hop
            protocol_version = 'HTTP/1.1'

            def log_message(self, *a):
                pass

            def _send(self, status, payload: bytes,
                      ctype='application/json', retry_after=None):
                self.send_response(status)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(payload)))
                if retry_after is not None:
                    self.send_header('Retry-After', str(retry_after))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if self.path == '/metrics':
                    from mlcomp_tpu_torch.telemetry.export import (
                        OPENMETRICS_CONTENT_TYPE,
                    )
                    return self._send(
                        200, gateway.render_metrics().encode(),
                        ctype=OPENMETRICS_CONTENT_TYPE)
                if self.path == '/health':
                    return self._send(200, json.dumps(
                        gateway.health()).encode())
                self._send(404, b'{"error": "not found"}')

            def do_POST(self):
                # body first: keep-alive clients (bench, SDKs reusing
                # a connection) would otherwise desync on early
                # returns — the unread body becomes the next request
                n = int(self.headers.get('Content-Length', 0))
                body = self.rfile.read(n) if n else b'{}'
                path = self.path
                if not path.startswith('/predict'):
                    return self._send(404, b'{"error": "not found"}')
                supplied = self.headers.get('Authorization', '').strip()
                if supplied != gateway.token:
                    return self._send(401, b'{"error": "unauthorized"}')
                if gateway._draining:
                    return self._send(
                        503, b'{"error": "gateway draining"}',
                        retry_after=1)
                name = path[len('/predict/'):] \
                    if path.startswith('/predict/') else ''
                if not name:
                    with gateway.routes_lock:
                        names = sorted(gateway.routes)
                    if len(names) != 1:
                        return self._send(400, json.dumps(
                            {'error': 'POST /predict/<fleet>',
                             'fleets': names}).encode())
                    name = names[0]
                probe = self.headers.get(PROBE_HEADER) is not None
                trace_id = (self.headers.get(TRACE_HEADER) or '') \
                    .strip() or None
                status, payload = gateway.proxy_predict(
                    name, body, probe=probe, trace_id=trace_id)
                self._send(status, payload,
                           retry_after=1 if status in (429, 503)
                           else None)

        return Handler

    def health(self) -> dict:
        with self.routes_lock:
            routes = dict(self.routes)
        return {'status': 'draining' if self._draining else 'ok',
                'fleets': {name: r.snapshot()
                           for name, r in routes.items()}}

    def render_metrics(self) -> str:
        """The gateway half of the fleet's /metrics surface: request
        outcomes, shed/hedge counters, breaker states, latency buckets
        — in-process truth a scraper reads directly (the API server
        re-exports the DB-backed fleet state for the rest)."""
        from mlcomp_tpu_torch.telemetry.export import (
            family, render_openmetrics,
        )
        gen, reqs, shed, hedge, backends, buckets = [], [], [], [], [], []
        with self.routes_lock:
            routes = dict(self.routes)
        for name, r in routes.items():
            snap = r.snapshot()
            gen.append(('', {'fleet': name}, snap['generation']))
            for outcome, value in (('ok', snap['ok']),
                                   ('shed', snap['shed']),
                                   ('error', snap['errors'])):
                reqs.append(('_total', {'fleet': name,
                                        'outcome': outcome}, value))
            shed.append(('_total', {'fleet': name}, snap['shed']))
            hedge.append(('_total', {'fleet': name}, snap['hedges']))
            states = {}
            for b in snap['backends']:
                states[b['circuit']] = states.get(b['circuit'], 0) + 1
            for circuit, count in sorted(states.items()):
                backends.append(
                    ('', {'fleet': name, 'circuit': circuit}, count))
            hist = self.telemetry.histogram_snapshot(
                f'fleet.{name}.latency_ms')
            if hist is not None:
                bucket_counts, count, total = hist
                for le, c in bucket_counts:
                    buckets.append(
                        ('_bucket', {'fleet': name, 'le': le}, c))
                buckets.append(('_count', {'fleet': name}, count))
                buckets.append(('_sum', {'fleet': name}, total))
        return render_openmetrics([
            family('mlcomp_gateway_up', 'gauge',
                   'gateway is accepting requests',
                   [('', None, 0 if self._draining else 1)]),
            family('mlcomp_fleet_generation', 'gauge',
                   'active (routed) swap generation per fleet', gen),
            family('mlcomp_fleet_requests', 'counter',
                   'gateway requests by outcome', reqs),
            family('mlcomp_fleet_shed', 'counter',
                   'requests shed by SLO-keyed admission control',
                   shed),
            family('mlcomp_fleet_hedges', 'counter',
                   'hedged retries spent from the budget', hedge),
            family('mlcomp_fleet_backends', 'gauge',
                   'routed backends by circuit-breaker state',
                   backends),
            family('mlcomp_fleet_latency_ms', 'histogram',
                   'gateway-observed end-to-end latency, cumulative '
                   'buckets', buckets),
        ])

    def flush_telemetry(self, session=None):
        """Persist the cumulative counters + latency buckets so the API
        server's /metrics re-exports the gateway's view (the windowed
        ``fleet.<name>.shed`` rows feed mlcomp_fleet_shed_total
        there)."""
        session = session or self.session
        if session is None:
            return
        with self.routes_lock:
            routes = dict(self.routes)
        for name, r in routes.items():
            snap = r.snapshot()
            self.telemetry.gauge(f'fleet.{name}.shed_cum', snap['shed'])
            self.telemetry.gauge(f'fleet.{name}.requests_cum',
                                 snap['requests'])
        self.telemetry.flush(session)
        # the gateway spans minted per proxied predict ride the same
        # flush cadence — without this the trace forest never sees the
        # gateway hop
        from mlcomp_tpu_torch.telemetry.spans import flush_spans
        flush_spans(session)

    # -------------------------------------------------------- lifecycle
    def bind(self):
        if self.httpd is None:
            self.httpd = ThreadingHTTPServer(
                (self.host, self.port), self._handler())
            self.port = self.httpd.server_address[1]
        return self.port

    def serve_forever(self):
        self.bind()
        self.start_refresh()
        with self._lifecycle:
            if self._closed:
                return
            self._serving = True
        try:
            self.httpd.serve_forever()
        finally:
            # under the same lock shutdown() reads it with — an
            # unguarded write here races the serving/closed handshake
            with self._lifecycle:
                self._serving = False

    def start_background(self):
        self.bind()
        self.start_refresh()
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return self

    def drain(self):
        self._draining = True

    def shutdown(self):
        self._refresh_stop.set()
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=5)
            self._refresh_thread = None
        if self.httpd is not None:
            with self._lifecycle:
                self._closed = True
                serving = self._serving
            if serving:
                self.httpd.shutdown()
            self.httpd.server_close()


__all__ = ['FleetGateway', 'CircuitBreaker', 'HedgeBudget',
           'RollingSlo', 'PROBE_HEADER', 'TRACE_HEADER']
