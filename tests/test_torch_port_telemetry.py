"""The port's device telemetry modules on the CPU, against the JAX
package's jax-free ones: the phase clock and the host-sync tripwire (the
same marks give the same series), the kernel-build listener, the
recorder (CUDA values pulled at flush in one copy, ``async_flush``), the
FLOP counter (the hand kernels' formulas against ``FlopCounterMode``'s
count of their plain versions), the trace parser (JAX's fixture field
for field, a ``torch.profiler``-format trace with exact buckets, a real
CPU capture), the sampled-window engine with injected tracers and the
on-demand profiler.

Tolerances: every comparison here is exact (``==`` on floats the two
packages compute with the same arithmetic, and on integer FLOP counts),
but ``pytest.approx`` at its default relative 1e-6 where a bucket is a
sum of microsecond intervals rounded to 1e-4 ms."""

import gzip
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.db.migration import migrate as jax_migrate
from mlcomp_tpu.db.providers.telemetry import MetricProvider as JaxMetrics
from mlcomp_tpu.telemetry import attribution as jax_attribution
from mlcomp_tpu.telemetry import compile_events as jax_compile_events
from mlcomp_tpu.telemetry import deviceprof as jax_deviceprof
from mlcomp_tpu.telemetry import metrics as jax_metrics
from mlcomp_tpu.telemetry import trace_parse as jax_trace_parse
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.providers.telemetry import MetricProvider
from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.ops.flash_attention import (
    attention_flops, reference_attention, reference_attention_backward,
)
from mlcomp_tpu_torch.ops.int8_matmul import int8_train_matmul
from mlcomp_tpu_torch.telemetry import (
    PHASES, CompileEventRecorder, DeviceProfiler, FlopCounter,
    HostSyncTripwire, MetricRecorder, StepAttribution, TaskProfiler,
    TorchTracer, request_stop, request_trace, trace_status,
)
from mlcomp_tpu_torch.telemetry import trace_parse
from mlcomp_tpu_torch.telemetry.device import FirstStepProbe
from mlcomp_tpu_torch.telemetry.deviceprof import BUCKET_SERIES, step_marker
from mlcomp_tpu_torch.telemetry.memory import tensor_bytes

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'mini_device_trace.json.gz')


def _pending(recorder):
    return [(n, k, s, float(v)) for n, k, s, v in recorder._pending]


# ------------------------------------------------------------ attribution
@pytest.mark.parametrize('seed', range(4))
def test_attribution_series_equal_jax(seed):
    """A random mark sequence (phases skipped, repeated, steps left
    open at an epoch's end) through both packages' StepAttribution:
    the same ``step.phase.*`` series and epoch results."""
    rng = np.random.RandomState(seed)
    mine = StepAttribution(MetricRecorder())
    theirs = jax_attribution.StepAttribution(jax_metrics.MetricRecorder())
    t, step = 100.0, 0
    for _ in range(3):
        for _ in range(rng.randint(1, 12)):
            for phase in rng.choice(PHASES, rng.randint(1, 6)):
                t += float(rng.rand()) * 1e-2
                mine.begin(phase, now=t)
                theirs.begin(phase, now=t)
            t += float(rng.rand()) * 1e-3
            mine.step_end(step=step, now=t)
            theirs.step_end(step=step, now=t)
            step += 1
        assert mine.emit_epoch(epoch=step) == theirs.emit_epoch(epoch=step)
    assert PHASES == jax_attribution.PHASES
    assert _pending(mine.recorder) == _pending(theirs.recorder)
    assert {n for n, *_ in mine.recorder._pending} >= {
        'step.pipeline_efficiency'}


# -------------------------------------------------------- compile events
@pytest.mark.parametrize('seed', range(3))
def test_tripwire_flags_equal_jax(seed):
    """The same intervals (a noisy baseline with planted syncs) flag the
    same steps and record the same suspects."""
    rng = np.random.RandomState(seed)
    dts = rng.uniform(5.0, 9.0, 120)
    dts[rng.choice(np.arange(10, 120), 6, replace=False)] = \
        rng.uniform(200.0, 900.0, 6)
    mine = HostSyncTripwire(recorder=MetricRecorder())
    theirs = jax_compile_events.HostSyncTripwire(
        recorder=jax_metrics.MetricRecorder())
    flags = [(mine.observe(float(d), step=i),
              theirs.observe(float(d), step=i)) for i, d in enumerate(dts)]
    assert all(a == b for a, b in flags)
    assert mine.suspects == theirs.suspects == 6
    assert _pending(mine.recorder) == _pending(theirs.recorder)
    assert mine.recorder._counters == theirs.recorder._counters


def test_compile_events_record_kernel_builds(tmp_path, monkeypatch):
    """A kernel build (``ops/_build.py`` with a stand-in compiler that
    writes its ``-o`` file) lands as ``compile.backend_ms`` at the
    stamped step and counts ``compile.count``; the step is exempt from
    the tripwire once; uninstall detaches the listener."""
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, 'nvcc', lambda: str(nvcc))
    monkeypatch.setenv(_build.BUILD_ENV, str(tmp_path / 'build'))
    rec = MetricRecorder()
    events = CompileEventRecorder(recorder=rec)
    assert events.install() and events.install()
    try:
        events.step = 7
        _build.build(['fused_ce'])
        _build.build(['fused_ce'])          # on disk: no second build
        assert [(n, k, s) for n, k, s, _ in rec._pending] == [
            ('compile.backend_ms', 'series', 7)]
        assert rec._counters == {'compile.count': 1.0}
        assert events.events[0]['kernel'] == 'fused_ce'
        assert events.consume_dirty() and not events.consume_dirty()
    finally:
        events.uninstall()
    assert events._listener is None and not _build.BUILD_LISTENERS
    os.remove(_build.library_path('fused_ce'))
    _build.build(['fused_ce'])
    assert len(rec._pending) == 1


# ------------------------------------------------------------- recorder
def test_recorder_rows_equal_jax_and_tensors_pull_at_flush(tmp_path):
    """The JAX recorder's API on the same samples (tensors, numbers,
    counters, a [steps] array, histograms) gives the same rows; a tensor
    is pulled at flush, an unreduced one is dropped and counted."""
    port = Session.create_session(
        key=f'rec-{tmp_path}', connection_string=f'sqlite:///{tmp_path}/p.db')
    jax = JaxSession.create_session(
        key=f'rec-{tmp_path}', connection_string=f'sqlite:///{tmp_path}/j.db')
    try:
        migrate(port)
        jax_migrate(jax)
        rng = np.random.RandomState(0)
        recs = (MetricRecorder(session=port, task=3, component='train'),
                jax_metrics.MetricRecorder(session=jax, task=3,
                                           component='train'))
        for rec in recs:
            for step in range(5):
                rec.series('loss', torch.tensor(float(rng.rand())), step)
                rec.series('step_time_ms', 1.5 * step, step)
            rec.count('compile.count')
            rec.count('compile.count', 2)
            rec.series_array('acc', np.arange(3) / 4, start_step=10)
            rec.observe('lat', 0.25, buckets=[0.1, 1.0])
            rec.observe('lat', 2.0)
            rng = np.random.RandomState(0)
        recs[0].series('wide', torch.ones(3), 0)
        assert recs[0].close() == recs[1].close() > 0
        assert recs[0].dropped_count == 1 and recs[1].dropped_count == 0
        assert recs[0].next_step() == 0 and recs[0].next_step() == 1

        def rows(session):
            return [tuple(r) for r in session.query(
                'SELECT task, name, kind, step, value, component, tags '
                'FROM metric ORDER BY id')]
        assert rows(port) == rows(jax)
    finally:
        Session.cleanup(port.key)
        JaxSession.cleanup(jax.key)


def test_async_flush_runs_off_the_calling_thread(tmp_path):
    """A full window flushes on the background thread; ``close`` joins
    it and writes the rest."""
    port = Session.create_session(
        key=f'async-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/a.db')
    try:
        migrate(port)
        rec = MetricRecorder(session=port, task=1, flush_every=4,
                             async_flush=True)
        for step in range(10):
            rec.series('loss', torch.tensor(float(step)), step)
        assert rec._flush_thread is not None
        rec.close()
        values = [r['value'] for r in port.query(
            "SELECT value FROM metric WHERE name='loss' ORDER BY step")]
        assert values == [float(s) for s in range(10)]
        assert rec.flushed_count == 10 and rec.dropped_count == 0
    finally:
        Session.cleanup(port.key)


# ---------------------------------------------------------- FLOP counter
def _aten_flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


@pytest.mark.parametrize('b,t,h,d', [(2, 16, 3, 8), (1, 33, 2, 16)])
@pytest.mark.parametrize('causal', [False, True])
def test_attention_kernel_flops_equal_the_plain_count(b, t, h, d, causal):
    """What each flash kernel credits against ``FlopCounterMode``'s
    count of the plain version: the forward (``reference_attention``)
    exactly when non-causal, and half of it when causal (the plain
    version computes the masked half too); the two backward kernels
    together as autograd of the plain attention counts (dq: dP, dQ;
    dkv: dV, dK), no recompute. ``reference_attention_backward``
    recomputes the scores, one product more: 2.5 forwards."""
    gen = torch.Generator().manual_seed(b * t + h)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, requires_grad=True)
               for _ in range(3))
    kernel = attention_flops(b, t, t, h, d, causal)
    full = attention_flops(b, t, t, h, d, False)
    assert _aten_flops(lambda: reference_attention(q, k, v, causal)) == full
    assert kernel == (full // 2 if causal else full)
    out, lse = reference_attention(q, k, v, causal, with_lse=True)
    do = torch.randn(out.shape, generator=gen)
    assert _aten_flops(lambda: torch.autograd.grad(
        reference_attention(q, k, v, causal), (q, k, v), do)) == 3 * full
    assert _aten_flops(lambda: reference_attention_backward(
        q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(), do,
        causal)) == 5 * full // 2


def test_int8_train_matmul_counts_every_product():
    """``Int8TrainMatmul``: forward and both gradients, 2·M·N·K each; a
    bare ``torch._int_mm`` through the counter's added formula."""
    m, k, n = 32, 48, 24
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(m, k, generator=gen, requires_grad=True)
    w = torch.randn(n, k, generator=gen, requires_grad=True)
    with FlopCounter() as counter:
        y = int8_train_matmul(x, w, torch.float32)
        torch.autograd.grad(y.sum(), (x, w))
    assert counter.total == 3 * 2 * m * n * k
    qa = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen)
    qb = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen)
    with FlopCounter() as counter:
        torch._int_mm(qa, qb)
    assert counter.total == 2 * m * n * k


@pytest.mark.parametrize('causal', [False, True])
def test_kernel_ops_are_counted_where_they_launch(causal):
    """The three flash launches are ``mlcomp_tpu`` ops with FLOP
    formulas: on meta tensors (their Meta kernels do nothing) each
    counts one attention forward, in every counter open around it
    (nested ``FlopCounter``s, ``FlopCounterMode``), beside aten ops."""
    from torch.utils.flop_counter import FlopCounterMode
    b, t, h, d = 2, 16, 3, 8
    meta = lambda *shape: torch.empty(*shape, device='meta')  # noqa: E731
    q, k, v, do = (meta(b, t, h, d) for _ in range(4))
    lse, delta = meta(b, h, t), meta(b, h, t)
    ops = torch.ops.mlcomp_tpu
    one = attention_flops(b, t, t, h, d, causal)
    with FlopCounter() as outer, FlopCounterMode(display=False) as mode:
        torch.ones(4, 8) @ torch.ones(8, 2)
        with FlopCounter() as inner:
            ops.flash_attention_fwd(q, k, v, meta(b, t, h, d), lse, 0.5,
                                    causal)
            ops.flash_attention_fwd(q, k, v, meta(b, t, h, d), None, 0.5,
                                    causal)
        ops.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                   meta(b, t, h, d), 0.5, 0.5, causal)
        ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                    meta(b, t, h, d), meta(b, t, h, d), 0.5,
                                    causal)
    assert inner.total == 2 * one
    assert outer.total == mode.get_total_flops() == 2 * 4 * 8 * 2 + 4 * one


def test_flop_counter_imports_no_dynamo():
    """A counted step in a fresh process leaves ``torch._dynamo``
    unimported (``FlopCounterMode``'s first step imports it)."""
    import subprocess
    import sys
    code = (
        'import sys, torch\n'
        'from mlcomp_tpu_torch.telemetry.device import FlopCounter\n'
        'lin = torch.nn.Linear(8, 8)\n'
        'with FlopCounter() as c:\n'
        '    lin(torch.randn(4, 8)).sum().backward()\n'
        'print(c.total, "torch._dynamo" in sys.modules)\n')
    out = subprocess.run(
        [sys.executable, '-c', code], capture_output=True, text=True,
        check=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    # the forward's product and the weight's gradient (x needs none)
    assert out.stdout.split() == [str(2 * 2 * 4 * 8 * 8), 'False']


def test_first_step_probe_counts_the_step_it_runs():
    """The probe's step trains (the state moves), its FLOPs are the
    step's (a second step under a plain counter counts the same), and
    its bytes are the state and the batch (no allocator peak on the
    CPU: no temp key)."""
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.train.loop import (
        create_train_state, loss_for_task, make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer
    model = create_model('mlp', num_classes=4, hidden=[16], dtype='float32',
                         input_shape=(8, 8, 1), device='cpu',
                         generator=torch.Generator().manual_seed(0))
    optimizer, _ = make_optimizer({'name': 'adam', 'lr': 1e-3}, 10)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer, loss_for_task('softmax_ce'))
    x = torch.rand(16, 8, 8, 1, generator=torch.Generator().manual_seed(1))
    y = torch.arange(16) % 4
    before = {k: v.clone() for k, v in model.state_dict().items()}
    probe = FirstStepProbe(flops=True, memory=True,
                           device=torch.device('cpu'))
    probe.run(step, state, x, y)
    assert probe.done and state.step == 1
    assert any(not torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    assert probe.flops == _aten_flops(lambda: step(state, x, y)) > 0
    attribution = probe.attribution
    assert 'temp_bytes' not in attribution
    assert attribution['argument_bytes'] == attribution['total_bytes'] == \
        tensor_bytes(model, state.opt_state, (x, y)) > x.nbytes
    assert FirstStepProbe(flops=False, memory=False).done


# ----------------------------------------------------------- trace parse
def _kernel(pid, tid, ts, dur, name, cat='kernel'):
    return {'ph': 'X', 'cat': cat, 'name': name, 'pid': pid, 'tid': tid,
            'ts': ts, 'dur': dur, 'args': {'stream': tid}}


def _host(ts, dur, name, cat='user_annotation'):
    return {'ph': 'X', 'cat': cat, 'name': name, 'pid': 4242,
            'tid': 4242, 'ts': ts, 'dur': dur}


def _torch_events(devices: int) -> list:
    """One card's trace (two streams): compute [0,100] and [150,250]
    on stream 7, an NCCL kernel [200,400] on stream 13, a copy [450,500]
    and a memset [500,520]; the host's three step dispatches; events
    the parser must ignore (the device-side copy of an annotation, a
    CPU op, a launch call, flow events). ``devices`` copies it onto
    cards 0.."""
    events = [{'ph': 'M', 'name': 'thread_name', 'pid': 4242, 'tid': 4242,
               'args': {'name': 'python'}}]
    for dev in range(devices):
        events += [
            _kernel(dev, 7, 0.0, 100.0, 'void gemm_kernel<128>(Params)'),
            _kernel(dev, 7, 150.0, 100.0, 'fused_norm_fwd_kernel'),
            _kernel(dev, 13, 200.0, 200.0,
                    'ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)'),
            _kernel(dev, 7, 450.0, 50.0, 'Memcpy HtoD (Pinned -> Device)',
                    cat='gpu_memcpy'),
            _kernel(dev, 7, 500.0, 20.0, 'Memset (Device)',
                    cat='gpu_memset'),
            _kernel(dev, 7, -60.0, 700.0, 'ProfilerStep#1',
                    cat='gpu_user_annotation'),
            {'ph': 'f', 'cat': 'ac2g', 'name': 'ac2g', 'pid': dev,
             'tid': 7, 'ts': 0.0, 'id': 1}]
    events += [
        _host(-50.0, 60.0, 'ProfilerStep#1'),
        _host(300.0, 20.0, 'ProfilerStep#2'),
        _host(600.0, 10.0, 'ProfilerStep#3'),
        _host(-40.0, 30.0, 'aten::mm', cat='cpu_op'),
        _host(-30.0, 5.0, 'cudaLaunchKernel', cat='cuda_runtime')]
    return events


@pytest.mark.parametrize('devices', [1, 2])
def test_torch_trace_buckets_are_exact(devices):
    """Worked by hand: window 520 us (first kernel to last); compute
    the union [0,100]+[150,250] = 200; comm 200, of it 50 under compute
    on the card's other stream, so 150 exposed; io 50 + 20; busy
    [0,100]+[150,400]+[450,520] = 420, idle 100; host gaps between the
    three dispatches 290 + 280. Each card is one device line."""
    out = trace_parse.parse_trace_events(_torch_events(devices))
    n = devices
    assert out['window_ms'] == 0.52 and out['device_lines'] == n
    assert out['events'] == 5 * n
    assert out['buckets'] == {
        'compute_ms': 0.2 * n, 'comm_ms': 0.2 * n,
        'comm_exposed_ms': pytest.approx(0.15 * n),
        'io_ms': pytest.approx(0.07 * n), 'idle_ms': pytest.approx(0.1 * n),
        'busy_ms': pytest.approx(0.42 * n)}
    assert out['busy_frac'] == round(420 / 520, 6)
    assert out['exposed_comm_frac'] == 0.75
    assert out['host'] == {'dispatch_count': 3, 'dispatch_gap_ms': 0.57}
    ops = {o['op']: o for o in out['ops']}
    assert ops['ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)'][
        'category'] == 'collective'
    assert ops['Memset (Device)']['category'] == 'io'
    assert ops['void gemm_kernel<128>(Params)']['count'] == n
    assert 'ProfilerStep#1' not in ops


def test_host_time_split_is_exact():
    """Worked by hand on the trace above plus a wait on another thread
    inside step 2 and an op after the last step: the three dispatches
    cover 60 + 20 + 10 = 90 us; aten::mm [-40,-10] holds the launch
    [-30,-25], the sync [305,315] adds 10, so 40 us in ops or CUDA calls
    and 50 without; the op at 700 lies outside every step."""
    events = _torch_events(1) + [
        dict(_host(305.0, 10.0, 'cudaStreamSynchronize', cat='cuda_runtime'),
             tid=4243),
        _host(700.0, 50.0, 'aten::add', cat='cpu_op')]
    assert trace_parse.host_time_split(events) == {
        'steps': 3, 'step_ms': 0.09, 'op_ms': 0.04, 'python_ms': 0.05,
        'launches': 1, 'launch_ms': 0.005, 'sync_count': 1,
        'sync_ms': 0.01}
    # a JAX trace has dispatches and no torch CPU events
    jax_split = trace_parse.host_time_split(
        trace_parse.read_trace_events(FIXTURE))
    assert jax_split['op_ms'] == jax_split['launches'] == 0
    assert jax_split['python_ms'] == jax_split['step_ms']
    assert trace_parse.host_time_split([])['steps'] == 0


def test_jax_fixture_parses_as_jax_does(tmp_path):
    """``mini_device_trace.json.gz`` field for field, from the file and
    from a capture directory laid out as a profiler writes it."""
    assert trace_parse.parse_trace_file(FIXTURE) == \
        jax_trace_parse.parse_trace_file(FIXTURE)
    for stamp in ('2026_01', '2026_02'):
        d = tmp_path / 'plugins' / 'profile' / stamp
        d.mkdir(parents=True)
        shutil.copy(FIXTURE, d / 'a.trace.json.gz')
        shutil.copy(FIXTURE, d / 'b.trace.json.gz')
        os.utime(d, (1, 1) if stamp == '2026_01' else None)
    mine = trace_parse.parse_trace_dir(str(tmp_path))
    theirs = jax_trace_parse.parse_trace_dir(str(tmp_path))
    assert mine == theirs and mine['source'].endswith('2026_02')
    assert trace_parse.find_trace_files(str(tmp_path)) == \
        jax_trace_parse.find_trace_files(str(tmp_path))


def test_real_cpu_capture_is_found_and_parsed(tmp_path):
    """A ``torch.profiler`` capture of three steps by ``TorchTracer``,
    each dispatch under the engine's marker: the file lands in the
    layout ``find_trace_files`` walks, and the parse has the three
    dispatches and no device line (no CUDA activity on the CPU)."""
    model = torch.nn.Linear(16, 4)
    x = torch.randn(8, 16)
    tracer = TorchTracer(cuda=False)
    tracer.start(str(tmp_path))
    for step in range(3):
        with step_marker(step):
            model(x).sum().backward()
        time.sleep(0.002)
    path = tracer.stop()
    assert trace_parse.find_trace_files(str(tmp_path)) == [path]
    with gzip.open(path, 'rt') as fh:
        names = {e.get('name') for e in json.load(fh)['traceEvents']}
    assert {'ProfilerStep#0', 'ProfilerStep#2'} <= names
    out = trace_parse.parse_trace_dir(str(tmp_path))
    assert out['device_lines'] == 0 and out['window_ms'] == 0.0
    assert out['host']['dispatch_count'] == 3
    assert out['host']['dispatch_gap_ms'] >= 4.0
    split = trace_parse.host_time_split(trace_parse.read_trace_events(path))
    assert split['steps'] == 3 and split['launches'] == 0
    assert 0 < split['op_ms'] <= split['step_ms']
    assert split['python_ms'] == pytest.approx(
        split['step_ms'] - split['op_ms'], abs=1e-3)
    with pytest.raises(RuntimeError, match='no trace'):
        tracer.stop()


# ---------------------------------------------------------- deviceprof
def _fake_tracers(calls):
    """start copies the fixture into the capture dir (the layout the
    tracers write), stop records."""
    def start(out_dir):
        calls.append(('start', out_dir))
        dst = os.path.join(out_dir, 'plugins', 'profile', 'stamp')
        os.makedirs(dst)
        shutil.copy(FIXTURE, os.path.join(dst, 'h.trace.json.gz'))

    def stop():
        calls.append(('stop', None))
    return start, stop


def _wait_windows(prof, n, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and prof.windows < n:
        time.sleep(0.02)
    assert prof.windows >= n, (prof.windows, prof.failures)


@pytest.fixture()
def twin_dbs(tmp_path):
    port = Session.create_session(
        key=f'dp-{tmp_path}', connection_string=f'sqlite:///{tmp_path}/p.db')
    jax = JaxSession.create_session(
        key=f'dp-{tmp_path}', connection_string=f'sqlite:///{tmp_path}/j.db')
    migrate(port)
    jax_migrate(jax)
    yield port, jax
    Session.cleanup(port.key)
    JaxSession.cleanup(jax.key)


def _strip_time(series):
    return {name: [{k: v for k, v in row.items() if k != 'time'}
                   for row in rows] for name, rows in series.items()}


def test_deviceprof_cadence_and_rows_equal_jax(twin_dbs):
    """JAX's cadence test through both engines: windows at steps 10 and
    20, two dispatches each, the hit at 15 skipped while nothing parses
    (after the wait), the same tracer calls and the same devtime rows."""
    port, jax = twin_dbs
    out = {}
    for name, cls, session in (('port', DeviceProfiler, port),
                               ('jax', jax_deviceprof.DeviceProfiler, jax)):
        calls = []
        start, stop = _fake_tracers(calls)
        prof = cls(session, task_id=1, every=10, window=2,
                   tracer_start=start, tracer_stop=stop)
        for step in range(15):
            prof.on_step(step)
        _wait_windows(prof, 1)
        prof._parse_thread.join(5)
        for step in range(15, 25):
            prof.on_step(step)
        _wait_windows(prof, 2)
        out[name] = ([c[0] for c in calls], prof.skipped, prof.failures)
        for _, d in calls:
            if d:
                assert not os.path.exists(d)
    assert out['port'] == out['jax'] == (['start', 'stop'] * 2, 0, 0)
    mine = MetricProvider(port).series(task_id=1)
    assert _strip_time(mine) == _strip_time(JaxMetrics(jax).series(task_id=1))
    assert {f'devtime.{k}' for k in BUCKET_SERIES} <= set(mine)
    assert [r['step'] for r in mine['devtime.compute_ms']] == [10, 20]


def test_deviceprof_skips_while_parsing_and_when_blocked(twin_dbs):
    port, _ = twin_dbs
    calls = []
    start, stop = _fake_tracers(calls)
    release = []

    def slow_parser(out_dir):
        while not release:
            time.sleep(0.01)
        return trace_parse.parse_trace_dir(out_dir)

    blocked = []
    prof = DeviceProfiler(port, task_id=2, every=2, window=1,
                          tracer_start=start, tracer_stop=stop,
                          parser=slow_parser, blocked=lambda: bool(blocked))
    for step in range(8):              # window 2-3, then 4 and 6 skip
        prof.on_step(step)
    assert prof.skipped == 2 and prof.windows == 0
    release.append(True)
    _wait_windows(prof, 1)
    blocked.append(True)
    prof.on_step(8)
    assert prof.skipped == 3 and not prof.capturing
    blocked.clear()
    prof.on_step(10)
    assert prof.capturing
    prof.end_window()                  # the trainer's epoch end
    assert not prof.capturing
    _wait_windows(prof, 2)
    assert [c[0] for c in calls] == ['start', 'stop'] * 2


def test_deviceprof_close_flushes_an_open_window(twin_dbs):
    port, _ = twin_dbs
    calls = []
    start, stop = _fake_tracers(calls)
    prof = DeviceProfiler(port, task_id=3, every=5, window=100,
                          tracer_start=start, tracer_stop=stop)
    for step in range(7):
        prof.on_step(step)               # opens at 5, never fills
    assert prof.capturing and len(prof.start_seconds) == 1
    prof.close()
    assert not prof.capturing and prof.windows == 1
    assert 'devtime.comm_exposed_ms' in MetricProvider(port).series(
        task_id=3)


@pytest.mark.parametrize('fault', ['start', 'parse', 'stop'])
def test_deviceprof_failures_degrade_without_rows(twin_dbs, fault):
    port, _ = twin_dbs
    logged = []

    def start(out_dir):
        if fault == 'start':
            raise RuntimeError('profiler busy')

    def stop():
        if fault == 'stop':
            raise RuntimeError('no trace')
    prof = DeviceProfiler(port, task_id=4, every=2, window=1,
                          tracer_start=start, tracer_stop=stop,
                          logger=logged.append)
    for step in range(5):
        prof.on_step(step)
        if prof._parse_thread is not None:
            prof._parse_thread.join(5)
    prof.close()
    assert prof.failures == 2 and prof.windows == 0
    assert not prof.capturing
    failed = [m for m in logged if 'failed' in m]
    assert len(failed) == 2 and all(fault in m for m in failed)
    assert MetricProvider(port).series(task_id=4) == {}


def test_instrumented_step_marks_dispatches_while_a_trace_runs(tmp_path):
    """The wrapper brackets a step with ``ProfilerStep#<step>`` while a
    ``torch.profiler`` trace runs and only then, opens and closes the
    engine's windows on its cadence, and writes the step's series."""
    from mlcomp_tpu_torch.train.loop import instrumented_step
    calls = []
    start, stop = _fake_tracers(calls)
    engine = DeviceProfiler(None, task_id=0, every=4, window=2,
                            tracer_start=start, tracer_stop=stop)
    rec = MetricRecorder()
    wrapped = instrumented_step(
        lambda state, x: (state, {'loss': (x * 2).sum()}), rec,
        batch_size=4, attribution=StepAttribution(rec), deviceprof=engine)
    tracer = TorchTracer(cuda=False)
    for step in range(10):
        if step == 2:
            tracer.start(str(tmp_path))
        if step == 5:
            tracer.stop()
        wrapped(None, torch.ones(3))
        if engine._parse_thread is not None:
            engine._parse_thread.join(5)
    assert engine.capturing                 # the window at 8 holds 9
    engine.close()
    assert [c[0] for c in calls] == ['start', 'stop', 'start', 'stop']
    out = trace_parse.parse_trace_dir(str(tmp_path))
    assert out['host']['dispatch_count'] == 3          # steps 2, 3, 4
    names = [n for n, *_ in rec._pending]
    assert names.count('loss') == 10 and names.count('step_time_ms') == 9
    assert names.count('step.phase.compute_ms') == 10


# -------------------------------------------------- on-demand profiler
def test_task_profiler_lifecycle_and_parse_on_stop(twin_dbs, tmp_path):
    """requested -> tracing -> done with the parsed attribution and
    devtime rows; stop_requested ends a trace early; captures pruned to
    the newest three; the JAX package's reader of the request row sees
    the port's rows."""
    from mlcomp_tpu.telemetry import profiler as jax_profiler
    port, _ = twin_dbs
    out = str(tmp_path / 'prof')

    def fake_start(d):
        stamp = os.path.join(d, 'plugins', 'profile',
                             f's{time.time_ns()}')
        os.makedirs(stamp)
        shutil.copy(FIXTURE, os.path.join(stamp, 'h.trace.json.gz'))

    prof = TaskProfiler(port, 11, str(tmp_path), tracer_start=fake_start,
                        tracer_stop=lambda: None)
    assert not prof.poll() and trace_status(port, 11) == {'status': 'none'}
    for _ in range(4):
        request_trace(port, 11, out_dir=out, max_epochs=2)
        assert prof.poll() and trace_status(port, 11)['status'] == 'tracing'
        assert prof.poll()                     # one of two epochs
        prof.poll()
        row = trace_status(port, 11)
        assert row['status'] == 'done' and row['epochs'] == 2
        assert row['attribution']['buckets']['comm_ms'] == \
            pytest.approx(1.1)
    request_trace(port, 11, out_dir=out, max_epochs=5)
    assert prof.poll()
    request_stop(port, 11)
    assert not prof.poll()
    assert trace_status(port, 11)['status'] == 'done'
    assert len(os.listdir(os.path.join(out, 'plugins', 'profile'))) == 3
    assert len(MetricProvider(port).series(task_id=11)[
        'devtime.summary']) == 5
    assert jax_profiler.AUX_PREFIX == 'telemetry:profile:'
