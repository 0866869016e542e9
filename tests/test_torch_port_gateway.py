"""The port's routing gateway (``mlcomp_tpu_torch/server/gateway.py``)
against the JAX package's (``mlcomp_tpu/server/gateway.py``), on the CPU.

Every case runs the same script through JAX's classes and the port's:
the circuit breaker, the hedge budget and the rolling SLO window under
one injected clock (no sockets), the fleet route's atomic admission
under a thread burst, and the full proxy path of ``FleetGateway`` over
real HTTP against the same stub backends (round-robin, failover on 5xx
and 429, the 4xx passthrough, 503 with no backend, shedding over the
SLO, the ``max_pending`` backstop, the probe bypass, an unknown fleet,
a wrong token). The states, status codes, headers and counters must be
equal. The ``gateway`` command runs in one subprocess with torch
unimportable: the gateway process holds no CUDA context.

Stubs answer at once, but in the ``max_pending`` case, where the
answer waits for an event the test sets.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from mlcomp_tpu_torch import TOKEN

jax_gw = importlib.import_module('mlcomp_tpu.server.gateway')
port_gw = importlib.import_module('mlcomp_tpu_torch.server.gateway')
PACKAGES = (jax_gw, port_gw)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both(script):
    """``script(module)`` for JAX's gateway module and the port's; the
    two results must be equal. Returns the port's."""
    theirs, mine = (script(m) for m in PACKAGES)
    assert mine == theirs
    return mine


# ---------------------------------------------------- router logic, no I/O
BREAKER_SCRIPTS = {
    # (threshold, cooldown, [(op, clock)], last state) — op is a
    # breaker method name
    'open_half_open_close': (3, 10.0, [
        ('allow', 0.0), ('record_failure', 0.0), ('record_failure', 0.0),
        ('record_failure', 0.0), ('allow', 1.0), ('allow', 10.1),
        ('allow', 10.1), ('record_success', 10.2), ('allow', 10.2)],
        'closed'),
    'half_open_failure_reopens': (1, 5.0, [
        ('record_failure', 0.0), ('allow', 5.1), ('record_failure', 5.1),
        ('allow', 5.2), ('allow', 10.2)], 'half_open'),
    'success_resets_streak': (3, 10.0, [
        ('record_failure', 0.0), ('record_failure', 0.0),
        ('record_success', 0.0), ('record_failure', 0.0),
        ('record_failure', 0.0), ('allow', 0.0)], 'closed'),
    'release_trial_without_verdict': (1, 5.0, [
        ('record_failure', 0.0), ('allow', 6.0), ('allow', 6.0),
        ('release_trial', 6.0), ('allow', 6.0), ('record_success', 6.0)],
        'closed'),
}


@pytest.mark.parametrize('case', sorted(BREAKER_SCRIPTS))
def test_circuit_breaker(case):
    threshold, cooldown, ops, last = BREAKER_SCRIPTS[case]

    def script(gw):
        clock = [0.0]
        cb = gw.CircuitBreaker(failure_threshold=threshold,
                               cooldown_s=cooldown, clock=lambda: clock[0])
        trail = []
        for op, t in ops:
            clock[0] = t
            result = getattr(cb, op)()
            trail.append((op, result, cb.state, cb.failures,
                          cb._trial_inflight))
        return trail

    trail = both(script)
    assert trail[-1][2] == last


@pytest.mark.parametrize('ratio,burst,ops', [
    (0.5, 2.0, 'sssnsnss'),
    (1.0, 3.0, 'n' * 100 + 's' * 10),
    (0.0, 5.0, 'ssrsssss'),
])
def test_hedge_budget(ratio, burst, ops):
    """s = try_spend, n = note_request, r = refund."""
    names = {'s': 'try_spend', 'n': 'note_request', 'r': 'refund'}

    def script(gw):
        budget = gw.HedgeBudget(ratio=ratio, burst=burst)
        return [(getattr(budget, names[op])(), budget.tokens)
                for op in ops]

    both(script)


@pytest.mark.parametrize('case', ['min_samples', 'age_expiry', 'tail',
                                  'no_slo'])
def test_rolling_slo(case):
    def script(gw):
        clock = [0.0]
        slo = gw.RollingSlo(None if case == 'no_slo' else 10.0,
                            min_samples=5, max_age_s=10.0,
                            clock=lambda: clock[0])
        trail = []
        samples = {'min_samples': [100.0] * 5, 'age_expiry': [100.0] * 10,
                   'tail': [1.0] * 99 + [500.0], 'no_slo': [100.0] * 10}
        for i, ms in enumerate(samples[case]):
            clock[0] = i * 0.01
            slo.observe(ms)
            trail.append((slo.p99(), slo.over_slo()))
        clock[0] = 10.5             # every sample older than max_age_s
        trail.append((slo.p99(), slo.over_slo(), len(slo.window)))
        return trail

    both(script)


def test_admission_burst_never_overshoots_max_pending():
    """A 16-thread burst on a route of ``max_pending`` 4 admits exactly 4
    in both packages; the probe is admitted over a full queue."""
    def script(gw):
        route = gw._FleetRoute('m', slo_p99_ms=None, max_pending=4)
        barrier = threading.Barrier(16)
        verdicts = []
        lock = threading.Lock()

        def client():
            barrier.wait()
            ok = route.admit()
            with lock:
                verdicts.append(ok)

        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        probe = route.admit(probe=True)
        snap = route.snapshot()
        for _ in range(5):
            route.release()
        return (sum(verdicts), probe, snap['inflight'], snap['shed'],
                snap['requests'], route.admit(), route.inflight)

    assert both(script) == (4, True, 5, 12, 17, True, 1)


# ------------------------------------------------------- the proxy, HTTP
def make_stub(behavior):
    """A replica stand-in; ``behavior``: status, gate (an Event the
    answer waits for), count."""
    class Stub(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get('Content-Length', 0))
            self.rfile.read(n)
            behavior['count'] = behavior.get('count', 0) + 1
            if behavior.get('gate') is not None:
                behavior['gate'].wait(timeout=30)
            status = behavior.get('status', 200)
            blob = json.dumps({'y': [behavior['index']],
                               'status': status}).encode()
            self.send_response(status)
            self.send_header('Content-Length', str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

    srv = ThreadingHTTPServer(('127.0.0.1', 0), Stub)
    behavior['port'] = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture()
def stubs():
    behaviors = [{'index': 0}, {'index': 1}]
    servers = [make_stub(b) for b in behaviors]
    yield behaviors
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def post(gw, path='/predict/m', body=b'{"x": [[1]]}', headers=None,
         token=TOKEN):
    req = urllib.request.Request(
        f'http://127.0.0.1:{gw.port}{path}', data=body,
        headers={'Authorization': token, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read()), \
                resp.headers.get('Retry-After')
    except urllib.error.HTTPError as e:
        payload = e.read()
        return e.code, (json.loads(payload) if payload else {}), \
            e.headers.get('Retry-After')


def snapshot(route, behaviors):
    """The route's snapshot with backend urls as stub indexes and the
    latency read dropped (a wall time)."""
    snap = route.snapshot()
    index = {f'http://127.0.0.1:{b["port"]}': b['index'] for b in behaviors}
    snap['backends'] = [{**b, 'url': index[b['url']]}
                        for b in snap['backends']]
    snap.pop('p99_ms')
    return snap


def run_gateway(behaviors, scenario, **kw):
    """``scenario(gw, route, post)`` against a gateway of each package
    over the same stubs, every stub reset between the two; returns the
    port's outcome after asserting it equals JAX's."""
    def script(gw_module):
        for b in behaviors:
            for key in ('count', 'status', 'gate'):
                b.pop(key, None)
        setup = kw.get('setup')
        if setup:
            setup(behaviors)
        gw = gw_module.FleetGateway(
            port=0, hedge_ratio=kw.get('hedge_ratio', 0.1),
            breaker_kw=kw.get('breaker_kw'))
        route = gw.set_fleet(
            'm', 1, [f'http://127.0.0.1:{b["port"]}' for b in behaviors],
            slo_p99_ms=kw.get('slo_p99_ms'),
            max_pending=kw.get('max_pending'))
        gw.start_background()
        try:
            out = scenario(gw, route)
            return {'out': out, 'snap': snapshot(route, behaviors),
                    'counts': [b.get('count', 0) for b in behaviors]}
        finally:
            gw.shutdown()
    return both(script)


def test_round_robin(stubs):
    res = run_gateway(stubs, lambda gw, route: [
        post(gw) for _ in range(4)])
    assert [r[1]['y'][0] for r in res['out']] == [0, 1, 0, 1]


def test_failover_on_5xx_opens_the_breaker(stubs):
    def setup(behaviors):
        behaviors[0]['status'] = 500

    res = run_gateway(stubs, lambda gw, route: [
        post(gw)[0] for _ in range(10)], setup=setup, hedge_ratio=1.0,
        breaker_kw={'failure_threshold': 2, 'cooldown_s': 60.0})
    assert res['out'] == [200] * 10
    assert res['snap']['backends'][0]['circuit'] == 'open'
    assert res['counts'][0] == 2        # no traffic once the circuit opened


def test_hedge_budget_exhaustion_surfaces_errors(stubs):
    def setup(behaviors):
        for b in behaviors:
            b['status'] = 500

    def scenario(gw, route):
        route.hedge.tokens = 1.0
        return [post(gw)[0] for _ in range(4)]

    res = run_gateway(stubs, scenario, setup=setup, hedge_ratio=0.0,
                      breaker_kw={'failure_threshold': 100})
    assert res['out'] == [500] * 4
    assert (res['snap']['hedges'], res['snap']['errors']) == (1, 4)


def test_replica_429_fails_over_without_breaker_penalty(stubs):
    def setup(behaviors):
        behaviors[0]['status'] = 429

    res = run_gateway(stubs, lambda gw, route: [
        post(gw)[0] for _ in range(4)], setup=setup, hedge_ratio=1.0,
        breaker_kw={'failure_threshold': 1})
    assert res['out'] == [200] * 4
    assert res['snap']['backends'][0]['circuit'] == 'closed'


def test_client_4xx_passthrough_no_hedge(stubs):
    def setup(behaviors):
        for b in behaviors:
            b['status'] = 400

    res = run_gateway(stubs, lambda gw, route: post(gw)[0], setup=setup,
                      hedge_ratio=1.0)
    assert res['out'] == 400 and res['snap']['hedges'] == 0


def test_shedding_over_the_slo_and_the_probe_bypass(stubs):
    def scenario(gw, route):
        route.slo.min_samples = 5
        for _ in range(10):
            route.slo.observe(100.0)    # the window poisoned over the SLO
        shed = [post(gw)[::2] for _ in range(4)]
        probe = post(gw, headers={gw_probe(gw): '1'})[0]
        doc = parse_metrics(gw.render_metrics())
        return shed, probe, doc['mlcomp_fleet_shed']['samples'], \
            doc['mlcomp_fleet_requests']['samples'], \
            doc['mlcomp_gateway_up']['samples']

    res = run_gateway(stubs, scenario, slo_p99_ms=10.0)
    shed, probe, shed_samples, _, _ = res['out']
    assert shed == [(429, '1')] * 4 and probe == 200
    assert shed_samples == [['mlcomp_fleet_shed_total', {'fleet': 'm'}, 4]]


def test_max_pending_backstop(stubs):
    """One request holds the route's only slot (its replica answers
    when the gate opens); three more shed with 429."""
    def setup(behaviors):
        for b in behaviors:
            b['gate'] = threading.Event()

    def scenario(gw, route):
        codes = []
        first = threading.Thread(target=lambda: codes.append(post(gw)[0]))
        first.start()
        deadline = time.monotonic() + 30
        while route.inflight < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        shed = [post(gw)[::2] for _ in range(3)]
        for b in stubs:
            b['gate'].set()
        first.join(timeout=30)
        return codes, shed

    res = run_gateway(stubs, scenario, setup=setup, max_pending=1)
    assert res['out'] == ([200], [(429, '1')] * 3)


def test_no_backend_unknown_fleet_default_route_and_token(stubs):
    def script(gw_module):
        gw = gw_module.FleetGateway(port=0)
        gw.set_fleet('m', 1, [])
        gw.start_background()
        try:
            out = [post(gw)[::2], post(gw, path='/predict/nope')[:2],
                   post(gw, path='/predict')[::2],
                   post(gw, token='wrong')[0],
                   post(gw, path='/other')[0]]
            gw.set_fleet('n', 1, [
                f'http://127.0.0.1:{stubs[0]["port"]}'])
            out.append(post(gw, path='/predict')[:2])
            out.append(post(gw, path='/predict/n')[:2])
            gw.drain()
            out.append(post(gw)[::2])
            out.append(json.loads(json.dumps(gw.health()))['status'])
            return out
        finally:
            gw.shutdown()

    out = both(script)
    assert out[0] == (503, '1') and out[1][0] == 404
    assert out[3] == 401 and out[5][0] == 400 and out[6][0] == 200
    assert out[7] == (503, '1') and out[8] == 'draining'


def gw_probe(gw):
    return sys.modules[type(gw).__module__].PROBE_HEADER


def parse_metrics(text):
    """OpenMetrics text → {family: {'samples': [[name, labels, value]]}}
    through the port's parser, JSON round-tripped (tuples → lists)."""
    from mlcomp_tpu_torch.telemetry.export import parse_openmetrics
    return json.loads(json.dumps(parse_openmetrics(text)))


def test_render_metrics_families_match(stubs):
    def scenario(gw, route):
        for _ in range(3):
            post(gw)
        doc = parse_metrics(gw.render_metrics())
        lat = doc['mlcomp_fleet_latency_ms']['samples']
        return sorted(doc), [s for s in lat if s[0].endswith('_count')], \
            doc['mlcomp_fleet_backends']['samples'], \
            doc['mlcomp_fleet_generation']['samples']

    families, count, backends, generation = run_gateway(
        stubs, scenario)['out']
    assert count == [['mlcomp_fleet_latency_ms_count', {'fleet': 'm'}, 3]]
    assert backends == [['mlcomp_fleet_backends',
                         {'fleet': 'm', 'circuit': 'closed'}, 2]]
    assert generation == [['mlcomp_fleet_generation', {'fleet': 'm'}, 1]]


def test_refresh_keeps_the_breaker_of_a_surviving_backend(stubs):
    """``set_backends`` on the same generation keeps an open circuit; a
    new generation starts every backend fresh."""
    def script(gw_module):
        route = gw_module._FleetRoute('m', breaker_kw={
            'failure_threshold': 1})
        urls = [f'http://127.0.0.1:{b["port"]}' for b in stubs]
        route.set_backends(1, [(urls[0], 1), (urls[1], 2)])
        route.backends[0].breaker.record_failure()
        route.set_backends(1, [(urls[0], 1)])
        kept = route.backends[0].breaker.state
        route.set_backends(2, [(urls[0], 3)])
        return kept, route.backends[0].breaker.state, \
            route.backends[0].replica_id, route.generation

    assert both(script) == ('open', 'closed', 3, 2)


def test_gateway_command_without_torch(tmp_path):
    """``python -m mlcomp_tpu_torch.server gateway`` where importing
    torch, JAX or the JAX package raises: it binds, answers ``/health``
    and ``/metrics``, routes a fleet of the DB to nothing (503), and
    exits on SIGTERM."""
    from tests.test_torch_port_imports import _BLOCKER, FORBIDDEN
    root = tmp_path / 'root'
    code = _BLOCKER.format(
        blocked=FORBIDDEN + ('torch',), module='mlcomp_tpu_torch.server',
        argv=['gateway', '--port', '0', '--refresh', '0.1'])
    env = dict(os.environ, MLCOMP_TPU_ROOT=str(root), PYTHONPATH=REPO)
    env.pop('PYTEST_XDIST_WORKER', None)
    from mlcomp_tpu_torch.db.core import Session
    from mlcomp_tpu_torch.db.migration import migrate
    from mlcomp_tpu_torch.server.fleet import create_fleet
    os.makedirs(root / 'db')
    session = Session.create_session(
        key=f'gw-{tmp_path}',
        connection_string=f'sqlite:///{root}/db/sqlite.db')
    try:
        migrate(session)
        create_fleet(session, 'f', 'm', desired=1)
    finally:
        Session.cleanup(session.key)
    proc = subprocess.Popen([sys.executable, '-c', code], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith('gateway on http://127.0.0.1:'), \
            line + proc.stderr.read()
        port = int(line.split('http://127.0.0.1:')[1].split()[0])
        base = f'http://127.0.0.1:{port}'
        deadline = time.monotonic() + 30
        while True:
            with urllib.request.urlopen(base + '/health', timeout=10) as r:
                health = json.loads(r.read())
            if 'f' in health['fleets'] or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert health['status'] == 'ok'
        assert health['fleets']['f']['backends'] == []
        with urllib.request.urlopen(base + '/metrics', timeout=10) as r:
            assert b'mlcomp_gateway_up 1' in r.read()
        req = urllib.request.Request(base + '/predict/f', data=b'{}',
                                     headers={'Authorization': TOKEN})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 503
        assert e.value.headers.get('Retry-After') == '1'
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
