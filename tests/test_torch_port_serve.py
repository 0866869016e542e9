"""The port's serving process against the JAX package's, on the CPU.

Exports are written by the JAX package (``mlcomp_tpu.train.export``) in
the stacked and per-layer ``scan_layers`` layouts and read by the port's
own msgpack reader; ``ModelServer(device='cpu')`` must answer
``/predict`` with what JAX's ``make_predictor`` computes. The behaviour
cases of ``tests/test_serve.py`` (auth, routing errors, coalescing,
backpressure, drain) run against the port over real HTTP.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.train import export as jax_export
from mlcomp_tpu_torch import TOKEN
from mlcomp_tpu_torch.server import serve as port_serve
from mlcomp_tpu_torch.server.serve import ModelServer, resolve_model
from mlcomp_tpu_torch.train import export as port_export

#: f32 on both sides, same weights: summation order only
F32_TOL = 1e-5

SPEC = {'name': 'transformer_lm', 'vocab_size': 32, 'd_model': 16,
        'n_layers': 2, 'n_heads': 2, 'd_ff': 32, 'max_seq_len': 8,
        'dtype': 'float32'}
META = {'score': 0.5, 'input_shape': [8], 'input_dtype': 'int32'}


def _jax_export(folder, name, scan=True, seed=0, **overrides):
    spec = {**SPEC, 'scan_layers': scan, **overrides}
    model = jax_create_model(**spec)
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros((1, 8), np.int32))
    return jax_export.export_model(
        os.path.join(str(folder), name), variables['params'], spec,
        meta=META)


def _tokens(n, seed=0):
    return np.random.RandomState(seed).randint(0, 32, (n, 8)) \
        .astype(np.int32)


@pytest.fixture(scope='module')
def export(tmp_path_factory):
    return _jax_export(tmp_path_factory.mktemp('port_serve'), 'm')


def _start(srv):
    srv.bind()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture()
def server(export):
    srv = ModelServer(export, batch_size=8, activation='softmax', port=0,
                      device='cpu')
    assert srv.warmup() is True
    _start(srv)
    yield srv
    srv.shutdown()


def _post(srv, body, token=TOKEN, path='/predict', headers=None):
    req = urllib.request.Request(
        f'http://127.0.0.1:{srv.port}{path}',
        data=json.dumps(body).encode(),
        headers={'Authorization': token, **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _get(srv, path):
    with urllib.request.urlopen(f'http://127.0.0.1:{srv.port}{path}',
                                timeout=30) as resp:
        return resp.headers.get('Content-Type'), resp.read()


class TestParityWithJax:
    @pytest.mark.parametrize('scan', [True, False])
    @pytest.mark.parametrize('activation', [None, 'softmax'])
    def test_predict_matches_jax_predictor(self, tmp_path, scan,
                                           activation):
        path = _jax_export(tmp_path, 'lm', scan=scan, seed=1)
        x = _tokens(5, seed=2)
        ref = jax_export.make_predictor(file=path, batch_size=8,
                                        activation=activation)(x)
        srv = _start(ModelServer(path, batch_size=8, activation=activation,
                                 port=0, device='cpu'))
        try:
            out = np.asarray(_post(srv, {'x': x.tolist()})['y'])
        finally:
            srv.shutdown()
        assert out.shape == ref.shape == (5, 8, 32)
        np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)

    def test_argmax_matches_jax_exactly(self, export):
        x = _tokens(11, seed=3)
        ref = jax_export.make_predictor(file=export, batch_size=4,
                                        activation='argmax')(x)
        out = port_export.make_predictor(file=export, batch_size=4,
                                         activation='argmax',
                                         device='cpu')(x)
        assert out.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(out, ref)

    def test_bf16_export_serves(self, tmp_path):
        path = _jax_export(tmp_path, 'bf', dtype='bfloat16',
                           param_dtype='bfloat16')
        variables, spec = port_export.load_export(path)
        assert variables['params']['embed'].dtype == torch.bfloat16
        x = _tokens(3, seed=4)
        ref = jax_export.make_predictor(file=path, batch_size=4,
                                        activation='argmax')(x)
        out = port_export.make_predictor(file=path, batch_size=4,
                                         activation='argmax',
                                         device='cpu')(x)
        assert (out == ref).mean() >= 0.9       # bf16 near-ties may flip


class TestExportFormat:
    def test_reader_matches_flax(self, export):
        from flax import serialization
        with open(export, 'rb') as fh:
            ref = serialization.msgpack_restore(fh.read())
        ours, spec = port_export.load_export(export)
        assert spec == {**SPEC, 'scan_layers': True}
        assert jax.tree.structure(ours) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)

    def test_port_export_reads_in_jax(self, export, tmp_path):
        from mlcomp_tpu_torch.convert import params_from_jax, params_to_jax
        variables, spec = port_export.load_export(export)
        sd = params_from_jax(variables['params'])
        path = port_export.export_model(
            str(tmp_path / 'again'), params_to_jax(sd, SPEC['n_heads']),
            spec, meta=META)
        assert port_export.load_export_meta(path) == {'model': spec, **META}
        x = _tokens(4, seed=5)
        ref = jax_export.make_predictor(file=path, batch_size=4)(x)
        out = port_export.make_predictor(file=path, batch_size=4,
                                         device='cpu')(x)
        np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)

    def test_chunked_arrays_load(self, monkeypatch, tmp_path):
        from flax import serialization
        monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 256)
        blob = serialization.msgpack_serialize(
            {'params': {'w': np.arange(300, dtype=np.float32)
                        .reshape(30, 10)}})
        (tmp_path / 'c.msgpack').write_bytes(blob)
        variables, _ = port_export.load_export(str(tmp_path / 'c'))
        np.testing.assert_array_equal(
            variables['params']['w'],
            np.arange(300, dtype=np.float32).reshape(30, 10))

    def test_writer_chunks_what_flax_reads(self, monkeypatch):
        from flax import serialization
        from mlcomp_tpu_torch.utils import msgpack_io
        monkeypatch.setattr(msgpack_io, 'MAX_CHUNK_SIZE', 100)
        tree = {'a': np.arange(64, dtype=np.float32).reshape(8, 8),
                'b': torch.arange(4.).bfloat16(), 's': np.int64(3)}
        back = serialization.msgpack_restore(
            msgpack_io.msgpack_serialize(tree))
        np.testing.assert_array_equal(back['a'], tree['a'])
        np.testing.assert_array_equal(np.asarray(back['b'], np.float32),
                                      np.arange(4.))
        assert back['s'] == 3

    def test_malformed_blob_raises(self, tmp_path):
        (tmp_path / 'bad.msgpack').write_bytes(b'\x82\xa1a')
        with pytest.raises(ValueError, match='truncated'):
            port_export.load_export(str(tmp_path / 'bad'))


class TestServe:
    def test_health_no_auth(self, server):
        _, raw = _get(server, '/health')
        body = json.loads(raw)
        assert body['status'] == 'ok'
        assert body['model'] == 'm'
        assert body['platform'] == 'cpu' and body['device'] == 'cpu'
        assert body['input_shape'] == [8]

    def test_single_example_gets_batch_dim(self, server):
        out = _post(server, {'x': [1, 2, 3, 4, 5, 6, 7, 0]})
        assert np.asarray(out['y']).shape == (1, 8, 32)

    def test_auth_and_errors(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, {'x': [[0] * 8]}, token='wrong')
        assert e.value.code == 401
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, {})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, {'x': 'not-numbers'})
        assert e.value.code == 400
        out = _post(server, {'x': _tokens(2).tolist()})
        assert np.asarray(out['y']).shape == (2, 8, 32)

    def test_every_request_size_matches_direct_predictor(self, server,
                                                         export):
        direct = port_export.make_predictor(
            file=export, batch_size=8, activation='softmax', device='cpu')
        for n in (5, 8, 11):
            x = _tokens(n, seed=n)
            out = np.asarray(_post(server, {'x': x.tolist()})['y'])
            assert out.shape == (n, 8, 32)
            np.testing.assert_allclose(out, direct(x), rtol=F32_TOL,
                                       atol=F32_TOL)

    def test_request_count_and_latency_in_health(self, server):
        for _ in range(3):
            _post(server, {'x': _tokens(2).tolist()})
        body = json.loads(_get(server, '/health')[1])
        assert body['requests'] == 3
        m = body['models']['m']
        assert m['queue_depth'] == 0 and m['max_pending'] == 256
        assert m['latency_ms']['window'] == 3
        assert 0 <= m['latency_ms']['p50'] <= m['latency_ms']['p99']

    def test_trace_header_records_a_span(self, server):
        from mlcomp_tpu_torch.telemetry.spans import DEFAULT_BUFFER
        DEFAULT_BUFFER.drain()
        _post(server, {'x': _tokens(1).tolist()},
              headers={port_serve.TRACE_HEADER: 'trace-42'})
        spans = [s for s in DEFAULT_BUFFER.drain()
                 if s['trace_id'] == 'trace-42']
        assert [s['name'] for s in spans] == ['serve.predict']
        assert spans[0]['tags'] == {'model': 'm', 'outcome': 'ok'}
        assert spans[0]['process_role'] == 'serving'


class TestCoalesce:
    def test_concurrent_requests_share_dispatches(self, export):
        srv = _start(ModelServer(export, batch_size=8, activation='softmax',
                                 port=0, coalesce_ms=120, device='cpu'))
        direct = port_export.make_predictor(
            file=export, batch_size=8, activation='softmax', device='cpu')
        xs = [_tokens(1, seed=i) for i in range(8)]
        results = [None] * 8
        before = srv.coalescer.dispatches

        def client(i):
            results[i] = np.asarray(_post(srv, {'x': xs[i].tolist()})['y'])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        try:
            for i in range(8):
                np.testing.assert_allclose(results[i], direct(xs[i]),
                                           rtol=F32_TOL, atol=F32_TOL)
            used = srv.coalescer.dispatches - before
            assert used < 8, f'{used} dispatches for 8 requests'
        finally:
            srv.shutdown()

    def test_batch_capacity_respected(self, export):
        srv = _start(ModelServer(export, batch_size=8, activation='softmax',
                                 port=0, coalesce_ms=250, device='cpu'))
        seen_rows = []
        inner = srv.coalescer.predict_padded
        srv.coalescer.predict_padded = \
            lambda x: (seen_rows.append(len(x)), inner(x))[1]
        results = {}

        def client(key, n, delay):
            time.sleep(delay)
            results[key] = np.asarray(_post(
                srv, {'x': _tokens(n).tolist()})['y']).shape

        threads = [threading.Thread(target=client, args=('small', 2, 0)),
                   threading.Thread(target=client, args=('big', 12, 0.05))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        try:
            assert results['small'] == (2, 8, 32)
            assert results['big'] == (12, 8, 32)
            assert max(seen_rows) <= 12 and 2 in seen_rows
        finally:
            srv.shutdown()

    def test_coalescer_keeps_shapes_apart(self, export):
        srv = _start(ModelServer(export, batch_size=8, activation='softmax',
                                 port=0, coalesce_ms=60, device='cpu'))
        outcomes = {}

        def client(key, arr):
            try:
                outcomes[key] = np.asarray(
                    _post(srv, {'x': arr.tolist()})['y']).shape
            except urllib.error.HTTPError as e:
                outcomes[key] = e.code

        good = _tokens(2)
        bad = np.zeros((2, 9), np.int32)      # longer than max_seq_len
        threads = [threading.Thread(target=client, args=('good', good)),
                   threading.Thread(target=client, args=('bad', bad))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        try:
            assert outcomes['good'] == (2, 8, 32)
            assert outcomes['bad'] == 500
        finally:
            srv.shutdown()


class TestMultiModel:
    def test_two_models_one_process(self, export, tmp_path):
        second = _jax_export(tmp_path, 'second', seed=3)
        srv = ModelServer([export, second], batch_size=8, port=0,
                          device='cpu')
        assert srv.warmup() is True
        _start(srv)
        try:
            x = _tokens(3).tolist()
            assert np.asarray(_post(srv, {'x': x}, path='/predict/m')['y'])\
                .shape == (3, 8, 32)
            assert np.asarray(
                _post(srv, {'x': x}, path='/predict/second')['y']).shape \
                == (3, 8, 32)
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv, {'x': x})
            assert e.value.code == 400
            assert sorted(json.loads(e.value.read())['models']) == \
                ['m', 'second']
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv, {'x': x}, path='/predict/nope')
            assert e.value.code == 404
            health = json.loads(_get(srv, '/health')[1])
            assert set(health['models']) == {'m', 'second'}
            assert health['models']['m']['requests'] == 1
        finally:
            srv.shutdown()

    def test_duplicate_names_rejected(self, export):
        with pytest.raises(ValueError, match='duplicate'):
            ModelServer([export, export], batch_size=8, port=0,
                        device='cpu')

    def test_same_name_across_projects_qualifies_routes(self, export,
                                                        tmp_path):
        import shutil
        base = export[:-len('.msgpack')]
        for proj in ('proj_a', 'proj_b'):
            (tmp_path / proj).mkdir()
            for ext in ('.msgpack', '.json'):
                shutil.copy(base + ext, str(tmp_path / proj / ('m' + ext)))
        srv = ModelServer([str(tmp_path / 'proj_a' / 'm'),
                           str(tmp_path / 'proj_b' / 'm')],
                          batch_size=8, port=0, device='cpu')
        try:
            assert set(srv.models) == {'proj_a/m', 'proj_b/m'}
            _start(srv)
            y = _post(srv, {'x': _tokens(2).tolist()},
                      path='/predict/proj_a/m')['y']
            assert np.asarray(y).shape == (2, 8, 32)
        finally:
            srv.shutdown()

    def test_failed_init_does_not_leak_coalescer_threads(self, export):
        before = {t.ident for t in threading.enumerate()}
        with pytest.raises(FileNotFoundError):
            ModelServer([export, '/nonexistent/model'], batch_size=8,
                        port=0, coalesce_ms=50, device='cpu')
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            leaked = [t for t in threading.enumerate()
                      if t.ident not in before and t.is_alive()]
            if not leaked:
                break
            time.sleep(0.05)
        assert not leaked


class TestRobustness:
    def _slow(self, srv, seconds):
        model = srv.primary
        inner = model.predict
        model.predict = lambda x: (time.sleep(seconds), inner(x))[1]

    def test_backpressure_429(self, export):
        srv = ModelServer(export, batch_size=8, port=0, max_pending=1,
                          device='cpu')
        srv.warmup()
        _start(srv)
        self._slow(srv, 0.3)
        codes, lock = [], threading.Lock()

        def client():
            try:
                _post(srv, {'x': _tokens(1).tolist()})
                code = 200
            except urllib.error.HTTPError as e:
                code = e.code
            with lock:
                codes.append(code)

        threads = [threading.Thread(target=client) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        try:
            assert 200 in codes and 429 in codes, codes
        finally:
            srv.shutdown()

    def test_graceful_drain_finishes_in_flight(self, export):
        srv = ModelServer(export, batch_size=8, port=0, device='cpu')
        srv.warmup()
        _start(srv)
        self._slow(srv, 0.5)
        result = {}
        t = threading.Thread(target=lambda: result.update(
            y=_post(srv, {'x': _tokens(1).tolist()})))
        t.start()
        time.sleep(0.15)
        done = {}
        st = threading.Thread(target=lambda: done.update(
            drained=srv.graceful_shutdown(drain_timeout_s=10)))
        st.start()
        time.sleep(0.1)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv, {'x': _tokens(1).tolist()})
        assert exc.value.code == 503
        t.join(timeout=30)
        st.join(timeout=30)
        assert done['drained'] is True
        assert 'y' in result

    def test_drain_admission_race_serves_accepted_request(self, export):
        srv = ModelServer(export, batch_size=8, port=0, device='cpu')
        srv.warmup()
        _start(srv)
        gate = threading.Event()
        orig_route = srv._route

        def held_route(path):
            gate.wait(10)
            return orig_route(path)
        srv._route = held_route
        result = {}

        def client():
            try:
                result['out'] = _post(srv, {'x': _tokens(1).tolist()})
            except urllib.error.HTTPError as e:
                result['code'] = e.code
        t = threading.Thread(target=client)
        t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with srv._inflight_lock:
                if srv._http_inflight:
                    break
            time.sleep(0.005)
        done = {}
        dt = threading.Thread(target=lambda: done.update(
            drained=srv.drain(timeout_s=10)))
        dt.start()
        deadline = time.monotonic() + 10
        while not srv._draining and time.monotonic() < deadline:
            time.sleep(0.005)
        gate.set()
        t.join(timeout=30)
        dt.join(timeout=30)
        try:
            assert 'out' in result, f'503d by the drain: {result}'
            assert done['drained'] is True
        finally:
            srv.shutdown()

    def test_post_drain_request_rejected_with_retry_after(self, export):
        srv = ModelServer(export, batch_size=8, port=0, device='cpu')
        _start(srv)
        try:
            assert srv.drain(timeout_s=5) is True
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv, {'x': _tokens(1).tolist()})
            assert e.value.code == 503
            assert e.value.headers.get('Retry-After') == '1'
            body = json.loads(_get(srv, '/health')[1])
            assert body['status'] == 'draining'
        finally:
            srv.shutdown()

    def test_drain_timeout_reports_false(self, export):
        srv = ModelServer(export, batch_size=8, port=0, device='cpu')
        _start(srv)
        self._slow(srv, 2.0)
        t = threading.Thread(target=lambda: _post(
            srv, {'x': _tokens(1).tolist()}))
        t.start()
        time.sleep(0.2)
        assert srv.graceful_shutdown(drain_timeout_s=0.2) is False
        t.join(timeout=30)

    def test_shutdown_before_serve_forever_is_safe(self, export):
        srv = ModelServer(export, batch_size=8, port=0, device='cpu')
        srv.bind()
        srv.shutdown()
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()


class TestFaultSeamsAndMetrics:
    def test_serve_request_raise_and_replica_slow(self, server):
        from mlcomp_tpu_torch.testing.faults import (
            clear_faults, configure_faults,
        )
        try:
            configure_faults({'serve.request': {'action': 'raise'}})
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server, {'x': _tokens(1).tolist()})
            assert e.value.code == 500
            assert np.asarray(_post(server, {'x': _tokens(1).tolist()})[
                'y']).shape == (1, 8, 32)
            configure_faults({'replica.slow': {'action': 'sleep',
                                               'ms': 120}})
            t0 = time.monotonic()
            _post(server, {'x': _tokens(1).tolist()})
            # the planted sleep alone guarantees this; a second timed
            # request varies with the load of other test workers
            assert time.monotonic() - t0 >= 0.12
        finally:
            clear_faults()

    def test_metrics_endpoint_is_valid_openmetrics(self, server):
        from mlcomp_tpu.telemetry.export import (
            OPENMETRICS_CONTENT_TYPE, parse_openmetrics,
        )
        for _ in range(4):
            _post(server, {'x': _tokens(2).tolist()})
        ctype, raw = _get(server, '/metrics')
        assert ctype == OPENMETRICS_CONTENT_TYPE
        doc = parse_openmetrics(raw.decode())
        assert doc['mlcomp_serving_up']['samples'][0][2] == 1
        reqs = doc['mlcomp_serving_requests']['samples']
        assert reqs[0][0] == 'mlcomp_serving_requests_total'
        assert reqs[0][1] == {'model': 'm'} and reqs[0][2] == 4
        lat = doc['mlcomp_serving_latency_ms']['samples']
        inf = [v for n, l, v in lat if l.get('le') == '+Inf']
        count = [v for n, l, v in lat if n.endswith('_count')]
        assert inf == count == [4]

    def test_health_buckets_are_cumulative(self, server):
        for _ in range(3):
            _post(server, {'x': _tokens(1).tolist()})
        buckets = json.loads(_get(server, '/health')[1])['models']['m'][
            'latency_buckets']
        assert buckets[-1] == ['+Inf', 3]
        counts = [n for _, n in buckets]
        assert counts == sorted(counts)


class TestResolve:
    def test_explicit_path(self, export):
        assert resolve_model(export).endswith('m')
        assert resolve_model(export[:-len('.msgpack')]).endswith('m')

    def test_registry_lookup(self, export, tmp_path, monkeypatch):
        import shutil
        monkeypatch.setattr(port_serve, 'MODEL_FOLDER', str(tmp_path))
        base = export[:-len('.msgpack')]
        (tmp_path / 'proj').mkdir()
        for ext in ('.msgpack', '.json'):
            shutil.copy(base + ext, str(tmp_path / 'proj' / ('reg' + ext)))
        assert resolve_model('reg', 'proj')
        assert resolve_model('reg')
        with pytest.raises(FileNotFoundError):
            resolve_model('none', 'proj')
        (tmp_path / 'other').mkdir()
        shutil.copy(base + '.msgpack', str(tmp_path / 'other' / 'reg.msgpack'))
        with pytest.raises(ValueError, match='multiple projects'):
            resolve_model('reg')

    def test_same_root_and_token_as_jax_package(self):
        import mlcomp_tpu
        import mlcomp_tpu_torch
        assert mlcomp_tpu_torch.ROOT_FOLDER == mlcomp_tpu.ROOT_FOLDER
        assert mlcomp_tpu_torch.MODEL_FOLDER == mlcomp_tpu.MODEL_FOLDER
        assert mlcomp_tpu_torch.TOKEN == mlcomp_tpu.TOKEN


class TestDeviceAndUnported:
    def test_entry_points_default_to_cuda(self, export):
        if torch.cuda.is_available():
            pytest.skip('a CUDA device is present')
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ModelServer(export, port=0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_export.make_predictor(file=export)

    def test_int8_quantize_not_ported(self, export):
        """int8 serving is ported now (tests/test_torch_port_int8.py):
        the server builds with it — this small export has no kernel of
        65,536 elements, so nothing is swapped, as JAX's interceptor
        quantizes nothing — and any other value still raises."""
        srv = ModelServer(export, port=0, quantize='int8', device='cpu')
        try:
            assert srv.primary.predict.quantized == 0
        finally:
            srv.shutdown()
        with pytest.raises(ValueError, match="'int8'"):
            ModelServer(export, port=0, quantize='int4', device='cpu')
