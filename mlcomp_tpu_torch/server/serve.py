"""Standalone model-serving process on the card (port of
``mlcomp_tpu/server/serve.py``).

    python -m mlcomp_tpu_torch.server serve my_model --project p

loads the self-describing msgpack export ONCE (either package's), builds
the predictor on the device (``device='cuda'`` unless the caller asks
for the CPU; ``quantize='int8'`` serves its large projections through
the weight-only int8 kernel, ``train/export.py``), warms it at the static batch shape when the export's meta
carries ``input_shape``, and serves:

- ``GET  /health``   (no auth) — model names, platform and device name,
  request counts, latency percentiles + cumulative bucket counts
- ``GET  /metrics``  (no auth) — OpenMetrics export of the in-process
  registries (request totals, queue depth, cumulative latency histogram
  buckets)
- ``POST /predict``  ``{"x": [[...]]}`` → ``{"y": [...], "ms": ...}``
  (token auth, same header contract as the JSON API)

Several exports can share one process and one card (``serve model_a
model_b``): each gets its own predictor and ``POST /predict/<name>``
route. Requests serialize through one lock per model — concurrency
belongs in the batch dimension (``--batch-size``). ``--coalesce-ms W``
concatenates concurrent requests landing within a W-ms window into ONE
device dispatch of up to ``batch_size`` rows. SIGTERM drains: new
predicts get 503 with ``Retry-After`` while the in-flight ones finish.

The DB-backed registry heartbeat (``--register``) waits for the DB slice
of the port: ``start_heartbeat`` raises.
"""

import glob
import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mlcomp_tpu_torch import MODEL_FOLDER, TOKEN


class Backpressure(RuntimeError):
    """Raised when a model's pending-request bound is hit; the HTTP
    layer maps it to 429 so load balancers and clients back off instead
    of piling threads onto the device lock."""


#: latency bucket upper bounds (ms) for the serving histograms — the
#: spread covers a warmed single-batch apply (~1-10 ms) through a
#: coalesced/backpressured tail; +Inf is implicit (telemetry Histogram)
LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0)

#: trace-context header (canonical definition — the gateway imports it
#: to stamp proxied requests): a predict carrying it gets its replica
#: handling recorded as a ``role='serving'`` span under that trace, so
#: ``GET /telemetry/trace/<id>`` assembles gateway hop + replica work
TRACE_HEADER = 'X-MLComp-Trace'


def resolve_model(name_or_path: str, project: str = None) -> str:
    """An explicit path wins; otherwise look under
    MODEL_FOLDER/<project>/<name>.msgpack, searching all projects when
    none is given (unique match required)."""
    from mlcomp_tpu_torch.train.export import export_base
    base = export_base(name_or_path)
    if os.path.exists(base + '.msgpack'):
        return base
    if project:
        cand = os.path.join(MODEL_FOLDER, project, base)
        if os.path.exists(cand + '.msgpack'):
            return cand
        raise FileNotFoundError(
            f'no export {base!r} in project {project!r} '
            f'({cand}.msgpack missing)')
    hits = glob.glob(os.path.join(MODEL_FOLDER, '*', base + '.msgpack'))
    if len(hits) == 1:
        return hits[0][:-len('.msgpack')]
    if not hits:
        raise FileNotFoundError(
            f'no export {base!r} under {MODEL_FOLDER}/*/')
    raise ValueError(
        f'{base!r} exists in multiple projects '
        f'({sorted(os.path.basename(os.path.dirname(h)) for h in hits)})'
        f' — pass --project')


class _Coalescer:
    """Concatenate concurrent requests into one device dispatch.

    One worker thread owns the predictor. A request enqueues its rows
    and blocks; the worker takes the oldest request, keeps collecting
    same-example-shape requests until the batch is full or the window
    expires, runs ONE predict over the concatenation, and hands each
    requester its slice. Mismatched example shapes simply wait for
    their own batch — they never poison a neighbour's.
    """

    def __init__(self, predict_padded, batch_size: int,
                 window_s: float):
        self.predict_padded = predict_padded
        self.batch_size = batch_size
        self.window_s = window_s
        self.cv = threading.Condition()
        self.queue = []
        self.closed = False
        self.dispatches = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, x: np.ndarray) -> np.ndarray:
        item = {'x': x, 'event': threading.Event(),
                'y': None, 'err': None}
        with self.cv:
            if self.closed:
                raise RuntimeError('server shutting down')
            self.queue.append(item)
            self.cv.notify_all()
        item['event'].wait()
        if item['err'] is not None:
            raise item['err']
        return item['y']

    def _take_matching(self, shape, capacity):
        """Dequeue same-shape requests that FIT the remaining batch
        capacity, in arrival order; stop at the first one that doesn't
        (FIFO fairness — it starts the next batch instead of being
        jumped by smaller latecomers)."""
        take = []
        for i in list(self.queue):
            if i['x'].shape[1:] != shape:
                continue
            if len(i['x']) > capacity:
                break
            take.append(i)
            capacity -= len(i['x'])
            self.queue.remove(i)
        return take

    def _run(self):
        while True:
            with self.cv:
                while not self.queue and not self.closed:
                    self.cv.wait()
                if self.closed and not self.queue:
                    return
                first = self.queue.pop(0)
            batch = [first]
            rows = len(first['x'])
            deadline = time.monotonic() + self.window_s
            while rows < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                with self.cv:
                    more = self._take_matching(
                        first['x'].shape[1:], self.batch_size - rows)
                    if not more:
                        # nothing usable queued (empty, other shapes,
                        # or nothing fits) — sleep until notified, then
                        # try once more; never spin the window away
                        self.cv.wait(timeout=remaining)
                        more = self._take_matching(
                            first['x'].shape[1:],
                            self.batch_size - rows)
                # racy-but-latching: closed only ever flips False→True
                # and a stale False costs one extra (empty) wait in the
                # coalescing window at shutdown — re-locking here would
                # buy nothing
                # preflight: disable=cc-lockset — benign latch read
                if not more and self.closed:
                    break
                batch.extend(more)
                rows += sum(len(i['x']) for i in more)
            try:
                y = self.predict_padded(
                    np.concatenate([i['x'] for i in batch]))
                offset = 0
                for i in batch:
                    n = len(i['x'])
                    i['y'] = y[offset:offset + n]
                    offset += n
            except Exception as e:  # propagate to every caller
                for i in batch:
                    i['err'] = e
            self.dispatches += 1
            for i in batch:
                i['event'].set()

    def shutdown(self):
        with self.cv:
            self.closed = True
            self.cv.notify_all()
        self.thread.join(timeout=5)


class _ServedModel:
    """One export: predictor on the device + request path state."""

    def __init__(self, file: str, batch_size: int, activation, quantize,
                 coalesce_ms: float, max_pending: int = 256,
                 device='cuda'):
        from mlcomp_tpu_torch.train.export import (
            export_base, load_export_meta, make_predictor,
        )
        self.file = file
        self.name = os.path.basename(export_base(file))
        self.batch_size = batch_size
        self.predict = make_predictor(
            file=file, batch_size=batch_size, activation=activation,
            quantize=quantize, device=device)
        self.meta = load_export_meta(file)
        # integer-input exports (LM tokens) must be fed as integers
        self.in_dtype = np.dtype(self.meta.get('input_dtype',
                                               'float32'))
        self.requests = 0
        self.lock = threading.Lock()
        # bounded admission: requests beyond max_pending get 429
        # instead of queueing without limit (one model on one device —
        # waiting can only serialize; a client retry later is cheaper
        # than a thread pile-up now). Its counter has its OWN lock:
        # self.lock is held across the whole device call, and a 429
        # must not wait a full predict to be delivered
        self.max_pending = max_pending
        self.pending = 0
        self.admit_lock = threading.Lock()
        # last-K request latencies for /health percentiles — a ring, so
        # the stats track CURRENT behavior, not the process lifetime
        self.latencies_ms = deque(maxlen=1024)
        # telemetry histogram (assigned by ModelServer): per-request
        # observe is an in-memory aggregate with cumulative buckets —
        # the shape Prometheus rate() needs — read by /health and
        # /metrics alike
        self.telemetry = None
        self.coalescer = _Coalescer(
            self._predict_padded, batch_size, coalesce_ms / 1e3) \
            if coalesce_ms > 0 else None

    def warmup(self) -> bool:
        """Pay the first apply (kernel build and load, allocator warm-up)
        before the first request when the export records its
        per-example input shape — at the FULL static batch shape, the
        only shape requests are ever applied at (see _predict_padded)."""
        shape = self.meta.get('input_shape')
        if shape:
            self.predict(np.zeros([self.batch_size] + list(shape),
                                  self.in_dtype))
            return True
        return False

    def handle_predict(self, body: dict):
        # chaos seams (testing/faults.py): serve.request is
        # the generic raise/sleep hook; replica.slow models a degraded
        # replica (latency SLO breach without death); replica.crash an
        # unclean serving-box death mid-load (action 'exit' — no drain,
        # exactly like the real thing). Disabled cost: one module-
        # global check each.
        from mlcomp_tpu_torch.testing.faults import fault_point
        fault_point('serve.request', model=self.name)
        fault_point('replica.slow', model=self.name)
        fault_point('replica.crash', model=self.name, phase='request')
        x = body.get('x')
        if x is None:
            raise ValueError("body must carry 'x': [[...], ...]")
        x = np.asarray(x, self.in_dtype)
        # a single example (shape == the export's per-example
        # input_shape, or a flat vector) gets the batch dim added
        shape = self.meta.get('input_shape')
        if (shape and list(x.shape) == list(shape)) or x.ndim == 1:
            x = x[None]
        n = len(x)
        t0 = time.monotonic()
        with self.admit_lock:
            if self.pending >= self.max_pending:
                raise Backpressure(
                    f'{self.pending} requests pending (bound '
                    f'{self.max_pending}) — retry later')
            self.pending += 1
        try:
            if self.coalescer is not None and n:
                y = self.coalescer.submit(x)
                with self.lock:
                    self.requests += 1
            else:
                with self.lock:
                    y = self._predict_padded(x)
                    self.requests += 1
        finally:
            with self.admit_lock:
                self.pending -= 1
        ms = round((time.monotonic() - t0) * 1e3, 3)
        self.latencies_ms.append(ms)
        if self.telemetry is not None:
            self.telemetry.observe(f'serving.{self.name}.latency_ms',
                                   ms, buckets=LATENCY_BUCKETS_MS)
        return {'y': np.asarray(y).tolist(), 'ms': ms}

    def _predict_padded(self, x: np.ndarray) -> np.ndarray:
        """Apply at the ONE static batch shape, as the JAX package does:
        pad up to the batch (the predictor's chunking handles larger n
        at that same shape) and slice the padding back off — every
        dispatch does the same device work whatever its row count."""
        n = len(x)
        if 0 < n < self.batch_size:
            x = np.concatenate(
                [x, np.zeros((self.batch_size - n,) + x.shape[1:],
                             x.dtype)])
        return np.asarray(self.predict(x))[:n]

    def health(self) -> dict:
        lat = list(self.latencies_ms)
        stats = None
        if lat:
            stats = {'p50': round(float(np.percentile(lat, 50)), 3),
                     'p99': round(float(np.percentile(lat, 99)), 3),
                     'window': len(lat)}
        depth = self.pending
        if self.coalescer is not None:
            with self.coalescer.cv:
                depth = max(depth, len(self.coalescer.queue))
        return {'score': self.meta.get('score'),
                'input_shape': self.meta.get('input_shape'),
                'requests': self.requests,
                'queue_depth': depth,
                'max_pending': self.max_pending,
                'latency_ms': stats,
                # cumulative [(le_ms, count)] over the process lifetime
                # — the same counts /metrics exports as _bucket samples
                'latency_buckets':
                    [[le, n] for le, n in self._hist_snapshot()[0]]}

    def _hist_snapshot(self):
        """(bucket_counts, count, total) from the recorder's
        cumulative bucketed histogram — one locked, consistent view
        for /health and /metrics (a mid-observe read would break the
        +Inf-bucket == _count invariant). Zeroed buckets before the
        first request (or without a recorder)."""
        snap = self.telemetry.histogram_snapshot(
            f'serving.{self.name}.latency_ms') \
            if self.telemetry is not None else None
        if snap is None:
            empty = [(b, 0) for b in LATENCY_BUCKETS_MS] + \
                [('+Inf', 0)]
            return empty, 0, 0.0
        return snap


class ModelServer:
    """One process, one card, one HTTP endpoint — one or more
    predictors behind it."""

    def __init__(self, file, batch_size: int = 64,
                 activation: str = None, quantize: str = None,
                 host: str = '127.0.0.1', port: int = 4202,
                 token: str = None, coalesce_ms: float = 0,
                 max_pending: int = 256, device='cuda'):
        from mlcomp_tpu_torch.train.export import export_base
        from mlcomp_tpu_torch.utils.device import device_info, resolve_device
        self.device = resolve_device(device)
        self.device_info = device_info(self.device)
        files = [os.fspath(file)] \
            if isinstance(file, (str, os.PathLike)) \
            else [os.fspath(f) for f in file]
        if not files:
            raise ValueError('need at least one export to serve')
        # route names up front: same export name from two projects
        # (ensemble members are conventionally named alike) qualifies
        # EVERY clashing one with its parent folder; a true duplicate
        # (same stem AND parent) is an error
        stems = [os.path.basename(export_base(f)) for f in files]
        names = []
        for f, stem in zip(files, stems):
            name = stem
            if stems.count(stem) > 1:
                parent = os.path.basename(
                    os.path.dirname(os.path.abspath(f))) or 'root'
                name = f'{parent}/{stem}'
            if name in names:
                raise ValueError(
                    f'duplicate model {name!r} — the same export was '
                    f'passed twice')
            names.append(name)
        self.models = {}
        try:
            for f, name in zip(files, names):
                m = _ServedModel(f, batch_size, activation, quantize,
                                 coalesce_ms, max_pending=max_pending,
                                 device=self.device)
                m.name = name
                self.models[name] = m
        except Exception:
            # partial construction must not leak coalescer threads
            for m in self.models.values():
                if m.coalescer is not None:
                    m.coalescer.shutdown()
            raise
        self.primary = next(iter(self.models.values()))
        # shared in-memory latency-histogram recorder (/health and
        # /metrics read it)
        from mlcomp_tpu_torch.telemetry import MetricRecorder
        self.telemetry = MetricRecorder(component='serving')
        for m in self.models.values():
            m.telemetry = self.telemetry
        self.host, self.port = host, port
        self.token = TOKEN if token is None else token
        self.httpd = None
        self._lifecycle = threading.Lock()
        self._serving = False
        self._closed = False
        self._draining = False
        # HTTP-level in-flight count. The admission decision (serve vs
        # 503) is taken under _inflight_lock at the same instant the
        # request counts itself in, and drain() flips _draining under
        # that same lock — so every request is either admitted (drain
        # waits for it on this counter) or rejected, with no window
        # where an accepted request is 503'd by the drain waiting on it
        self._http_inflight = 0
        self._inflight_lock = threading.Lock()

    # ------------------------------------------------- single-model API
    # (the common case and the back-compat surface: name/meta/coalescer/
    # requests refer to the primary model when exactly one is served)
    @property
    def name(self):
        return self.primary.name

    @property
    def meta(self):
        return self.primary.meta

    @property
    def batch_size(self):
        return self.primary.batch_size

    @property
    def coalescer(self):
        return self.primary.coalescer

    @property
    def requests(self):
        return sum(m.requests for m in self.models.values())

    def warmup(self) -> bool:
        """True iff EVERY served export carried an input_shape to warm
        up with."""
        return all([m.warmup() for m in self.models.values()])

    def _route(self, path: str):
        """/predict → the only model; /predict/<name> → that model.
        Returns (model, error-payload)."""
        if path == '/predict':
            if len(self.models) == 1:
                return self.primary, None
            return None, (400, {
                'error': 'multiple models served — POST /predict/<name>',
                'models': sorted(self.models)})
        if path.startswith('/predict/'):
            name = path[len('/predict/'):]
            model = self.models.get(name)
            if model is None:
                return None, (404, {'error': f'no model {name!r}',
                                    'models': sorted(self.models)})
            return model, None
        return None, (404, {'error': 'not found'})

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive (every response carries Content-Length): the
            # fleet gateway pools persistent connections per replica —
            # HTTP/1.0 close-per-request would void the pool
            protocol_version = 'HTTP/1.1'

            def log_message(self, *a):
                pass

            def _send(self, code, payload):
                blob = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_GET(self):
                if self.path == '/metrics':
                    # OpenMetrics from the in-process registries — no
                    # DB, no auth (introspection tier like /health):
                    # a stock scraper watches a serving box directly
                    from mlcomp_tpu_torch.telemetry.export import (
                        OPENMETRICS_CONTENT_TYPE,
                    )
                    blob = server.render_metrics().encode()
                    self.send_response(200)
                    self.send_header('Content-Type',
                                     OPENMETRICS_CONTENT_TYPE)
                    self.send_header('Content-Length', str(len(blob)))
                    self.end_headers()
                    self.wfile.write(blob)
                    return
                if self.path != '/health':
                    return self._send(404, {'error': 'not found'})
                payload = {
                    'status': 'draining' if server._draining else 'ok',
                    'model': server.primary.name,
                    **server.device_info,
                    'score': server.primary.meta.get('score'),
                    'input_shape':
                        server.primary.meta.get('input_shape'),
                    'requests': server.requests,
                    'models': {name: m.health()
                               for name, m in server.models.items()}}
                self._send(200, payload)

            def do_POST(self):
                # admission is decided HERE, under the same lock
                # drain() flips _draining under: a request accepted
                # (inflight counted) before the flip is served to
                # completion — drain waits on the counter — and one
                # arriving after gets a clean 503. Deciding later (in
                # _do_post, as this code once did) left a window where
                # an accepted-but-not-yet-admitted request was 503'd by
                # the very drain that was waiting for it, which is how
                # a rolling swap fails the requests it promised not to.
                with server._inflight_lock:
                    server._http_inflight += 1
                    admitted = not server._draining
                try:
                    self._do_post(admitted)
                finally:
                    with server._inflight_lock:
                        server._http_inflight -= 1

            def _do_post(self, admitted: bool):
                # consume the request body FIRST, whatever the answer:
                # under HTTP/1.1 keep-alive an unread body would be
                # parsed as the NEXT request line on the same
                # connection — the gateway's pooled connections would
                # desync on every early return (404/401/drain-503)
                n = int(self.headers.get('Content-Length', 0))
                raw = self.rfile.read(n) if n else b''
                model, err = server._route(self.path)
                if err is not None:
                    return self._send(*err)
                supplied = self.headers.get('Authorization', '').strip()
                if supplied != server.token:
                    return self._send(401, {'error': 'unauthorized'})
                if not admitted:
                    # Retry-After: the router's cue to fail over to a
                    # live replica instead of surfacing the drain
                    self.send_response(503)
                    blob = json.dumps({
                        'error': 'server draining — shutting down',
                        'retry_after_s': 1}).encode()
                    self.send_header('Content-Type', 'application/json')
                    self.send_header('Content-Length', str(len(blob)))
                    self.send_header('Retry-After', '1')
                    self.end_headers()
                    self.wfile.write(blob)
                    return
                # trace read-back: a gateway-stamped (or client-
                # supplied) trace id joins this replica's handling to
                # the cross-process trace; traceless requests pay one
                # header read and nothing else
                trace_id = (self.headers.get(TRACE_HEADER) or '') \
                    .strip() or None
                started = time.time()
                t0 = time.monotonic()
                status = 'ok'
                try:
                    body = json.loads(raw or '{}')
                    reply = (200, model.handle_predict(body))
                except Backpressure as e:
                    status = 'backpressure'
                    reply = (429, {'error': str(e)})
                except (ValueError, TypeError) as e:
                    status = 'bad-request'
                    reply = (400, {'error': str(e)})
                except Exception as e:  # noqa — keep the server up
                    status = 'error'
                    reply = (500, {'error': str(e)})
                # the span is recorded before the reply goes out, so a
                # client that has its answer finds the span buffered
                if trace_id:
                    from mlcomp_tpu_torch.telemetry.spans import (
                        record_span,
                    )
                    record_span(
                        'serve.predict', started, time.monotonic() - t0,
                        tags={'model': model.name, 'outcome': status},
                        status='ok' if status != 'error' else 'error',
                        trace_id=trace_id, role='serving')
                self._send(*reply)

        return Handler

    def render_metrics(self) -> str:
        """OpenMetrics families from the in-process state: cumulative
        per-model latency buckets, request totals, live queue depth —
        the serving half of the fleet's /metrics surface."""
        from mlcomp_tpu_torch.telemetry.export import (
            family, render_openmetrics,
        )
        requests, depth, buckets = [], [], []
        for name, m in self.models.items():
            requests.append(('_total', {'model': name}, m.requests))
            # queue depth directly (health() would also sort a 1024-
            # sample percentile window per scrape just to be thrown
            # away)
            depth_val = m.pending
            if m.coalescer is not None:
                with m.coalescer.cv:
                    depth_val = max(depth_val, len(m.coalescer.queue))
            depth.append(('', {'model': name}, depth_val))
            hist_buckets, count, total = m._hist_snapshot()
            for le, n in hist_buckets:
                buckets.append(('_bucket', {'model': name, 'le': le},
                                n))
            buckets.append(('_count', {'model': name}, count))
            buckets.append(('_sum', {'model': name}, total))
        return render_openmetrics([
            family('mlcomp_serving_up', 'gauge',
                   'serving process is accepting requests',
                   # monitoring snapshot: a one-scrape-stale gauge is
                   # harmless; admission reads it under the lock
                   # preflight: disable=cc-lockset — see above
                   [('', None, 0 if self._draining else 1)]),
            family('mlcomp_serving_requests', 'counter',
                   'predict requests served per model', requests),
            family('mlcomp_serving_queue_depth', 'gauge',
                   'pending requests per model', depth),
            family('mlcomp_serving_latency_ms', 'histogram',
                   'per-request latency, cumulative process-lifetime '
                   'buckets', buckets),
        ])

    def bind(self):
        """Bind the listening socket (resolves ``port 0`` to the real
        ephemeral port) without blocking; ``serve_forever`` reuses it."""
        if self.httpd is None:
            self.httpd = ThreadingHTTPServer(
                (self.host, self.port), self._handler())
            self.port = self.httpd.server_address[1]
        return self.port

    def serve_forever(self):
        self.bind()
        with self._lifecycle:
            if self._closed:
                return
            self._serving = True
        try:
            self.httpd.serve_forever()
        finally:
            # under the same lock the shutdown handshake reads it with
            # — an unguarded write here races serving/closed
            with self._lifecycle:
                self._serving = False

    def start_heartbeat(self, session, interval_s: float = 10.0) -> str:
        """The DB-backed registry heartbeat (``--register``)."""
        raise NotImplementedError(
            'the serving registry heartbeat needs the DB, which is not '
            'ported yet (ROADMAP.md, queue A: the DB-backed heartbeat, '
            'spans flush and --register)')

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting predicts (503) and wait for in-flight ones to
        finish. Returns True when everything drained in time. /health
        reports 'draining' from the same moment. The flag flips under _inflight_lock — the same lock do_POST
        counts itself in under — so every request is EITHER admitted
        (and waited for below) or cleanly 503'd, never both-neither
        (the drain/admission race)."""
        with self._inflight_lock:
            self._draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._inflight_lock:
                busy = self._http_inflight
            if not busy:
                return True
            time.sleep(0.02)
        return False

    def graceful_shutdown(self, drain_timeout_s: float = 30.0) -> bool:
        """SIGTERM path: finish what's in flight, then shut down —
        a rolling restart must not fail the requests it interrupts.
        Returns drain success (False = timed out, shut down anyway)."""
        drained = self.drain(drain_timeout_s)
        self.shutdown()
        return drained

    def shutdown(self):
        for m in self.models.values():
            if m.coalescer is not None:
                m.coalescer.shutdown()
        if self.httpd is not None:
            # stdlib shutdown() BLOCKS until the serve_forever loop
            # acknowledges — calling it when the loop never started
            # would hang forever (bind()-only servers, tests); the
            # lifecycle lock closes the start/stop race (a loop that
            # lost the race exits before touching the closed socket)
            with self._lifecycle:
                self._closed = True
                serving = self._serving
            if serving:
                self.httpd.shutdown()
            self.httpd.server_close()


__all__ = ['ModelServer', 'resolve_model', 'Backpressure',
           'TRACE_HEADER']
