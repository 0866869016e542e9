"""Parser for the Chrome trace-event files a profiler writes (port of
``mlcomp_tpu/telemetry/trace_parse.py``), for ``torch.profiler``'s traces
and ``jax.profiler``'s alike.

The on-demand profiler (telemetry/profiler.py) and the sampled capture
engine (telemetry/deviceprof.py) leave trace directories shaped
``<dir>/plugins/profile/<timestamp>/<host>.trace.json.gz``. This module
turns one capture into a device-time attribution:

- device time bucketed into **compute**, **collective** and **io**, and
  **idle** (window time no device event covers);
- **exposed-comm**: the part of the collective interval union NOT
  covered by the compute interval union on the same device line;
- host-side **inter-dispatch gaps**: time between successive step
  dispatches on the busiest host line — the "host can't feed the
  device" signal;
- for a ``torch.profiler`` trace, ``host_time_split``: the host's time
  inside the dispatches, in aten ops and CUDA calls (launches and
  waits counted apart) against the rest, Python between ops.

A ``torch.profiler`` trace differs from a JAX one in four points:

- a device event is one whose ``cat`` is ``kernel``, ``gpu_memcpy`` or
  ``gpu_memset``; a device line is one card (the trace's ``pid`` of
  those events), all its streams together, so a collective on one
  stream is hidden by compute on another;
- ``nccl*`` kernels are collective, copies and memsets are io, every
  other kernel is compute;
- the step dispatches are the ``ProfilerStep#N`` annotations on the
  host (the deviceprof engine brackets each train-step call with one),
  in place of JAX's ``PjitFunction(...)``;
- the files are written in the JAX layout, which ``find_trace_files``
  walks.

For a JAX trace a device line is any (pid, tid) timeline that carries
XLA op events (``args.hlo_op`` / ``args.hlo_category``, or a thread
named ``XLA Ops``), and the op names are classified as there. A trace
with no device event still reports its host dispatches.

Timestamps are trace-event microseconds; all returned durations are
milliseconds.
"""

import glob
import gzip
import json
import os
import re

#: op-name prefixes classified as collective communication. Async
#: variants appear as ``<op>-start`` / ``<op>-done`` event pairs.
COLLECTIVE_PREFIXES = (
    'all-reduce', 'all-gather', 'reduce-scatter', 'collective-permute',
    'all-to-all', 'collective-broadcast',
)

#: op-name prefixes classified as host<->device IO.
IO_PREFIXES = ('infeed', 'outfeed', 'host-transfer', 'send', 'recv')

_ASYNC_RE = re.compile(
    r'^(?P<base>.+?)-(?P<kind>start|done)(?:\.\d+)?$')
_SUFFIX_RE = re.compile(r'\.\d+$')

#: host events that mark one executable dispatch.
_DISPATCH_RE = re.compile(
    r'^PjitFunction\(|Executable::Execute(Helper)?$|^XlaModule'
    r'|^ProfilerStep#\d+$')

#: torch.profiler's device event categories, with the bucket each is in
#: (None: by the kernel's name, ``event_category``)
TORCH_DEVICE_CATS = {'kernel': None, 'gpu_memcpy': 'io',
                     'gpu_memset': 'io'}


def classify_op(name: str) -> str:
    """Bucket for one HLO op name: 'collective' | 'io' | 'compute'."""
    n = name.lstrip('%').lower()
    for p in COLLECTIVE_PREFIXES:
        if n.startswith(p):
            return 'collective'
    for p in IO_PREFIXES:
        if n.startswith(p):
            return 'io'
    return 'compute'


def event_category(event: dict) -> str:
    """Bucket for one device event: a torch.profiler kernel, copy or
    memset by its category (``nccl*`` kernels are collectives), an XLA
    op by ``classify_op``."""
    bucket = TORCH_DEVICE_CATS.get(event.get('cat'))
    if bucket is not None:
        return bucket
    name = str(event.get('name', ''))
    if event.get('cat') == 'kernel':
        return 'collective' if name.lower().startswith('nccl') \
            else 'compute'
    return classify_op(name)


def op_base_name(name: str) -> str:
    """Aggregation key for an op: strip ``%``, ``.N`` suffixes and the
    async ``-start``/``-done`` marker (both halves tally to the op)."""
    n = _SUFFIX_RE.sub('', name.lstrip('%'))
    m = _ASYNC_RE.match(n)
    if m and classify_op(m.group('base')) == 'collective':
        return m.group('base')
    return n


def _is_op_event(event: dict) -> bool:
    args = event.get('args')
    return isinstance(args, dict) and (
        'hlo_op' in args or 'hlo_category' in args
        or 'hlo_module' in args)


def _union(intervals):
    """Total length + merged list of possibly-overlapping intervals."""
    if not intervals:
        return 0.0, []
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return sum(hi - lo for lo, hi in merged), merged


def _intersection_length(merged_a, merged_b):
    """Overlap length of two already-merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(merged_a) and j < len(merged_b):
        lo = max(merged_a[i][0], merged_b[j][0])
        hi = min(merged_a[i][1], merged_b[j][1])
        if hi > lo:
            total += hi - lo
        if merged_a[i][1] <= merged_b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _pair_async(events):
    """Collective intervals with async ``-start``/``-done`` pairs
    merged into one wall interval ``[start.begin, done.end]`` (the
    device owns the collective for that whole span; compute events
    scheduled inside it are the OVERLAPPED part). Sync collectives and
    unpaired halves keep their own extent. Returns (intervals,
    op_durations) where op_durations maps base op -> [ms, count] of
    raw event time (the per-op table should not double-count the
    hidden wait)."""
    intervals = []
    open_starts = {}            # base -> [begin, ...] FIFO
    for ev in events:
        name = ev['name'].lstrip('%')
        lo = float(ev['ts'])
        hi = lo + float(ev.get('dur') or 0.0)
        m = _ASYNC_RE.match(_SUFFIX_RE.sub('', name))
        if m and ev.get('cat') not in TORCH_DEVICE_CATS \
                and classify_op(m.group('base')) == 'collective':
            base, kind = m.group('base'), m.group('kind')
            if kind == 'start':
                open_starts.setdefault(base, []).append(lo)
                continue
            queue = open_starts.get(base)
            if queue:
                intervals.append((queue.pop(0), hi))
            else:
                intervals.append((lo, hi))   # unpaired done
            continue
        intervals.append((lo, hi))
    for base, starts in open_starts.items():
        for lo in starts:                    # unpaired start: zero-ish
            intervals.append((lo, lo))
    return intervals


def parse_trace_events(events):
    """Attribution from a list of trace events (the ``traceEvents``
    array). Returns a dict of millisecond buckets; see module doc for
    the taxonomy. Pure function — the unit tests pin the math here."""
    lines = {}                  # (pid, tid) -> [op events]
    host_lines = {}             # (pid, tid) -> [dispatch events]
    xla_threads = set()         # (pid, tid) named 'XLA Ops'
    for ev in events:
        if ev.get('ph') == 'M' and ev.get('name') == 'thread_name':
            tname = (ev.get('args') or {}).get('name', '')
            if 'XLA Ops' in str(tname):
                xla_threads.add((ev.get('pid'), ev.get('tid')))
    for ev in events:
        if ev.get('ph') != 'X' or ev.get('ts') is None:
            continue
        key = (ev.get('pid'), ev.get('tid'))
        if ev.get('cat') in TORCH_DEVICE_CATS:
            # one line per card: its streams run on one device
            lines.setdefault(('device', ev.get('pid')), []).append(ev)
        elif _is_op_event(ev) or key in xla_threads:
            lines.setdefault(key, []).append(ev)
        elif ev.get('cat') != 'gpu_user_annotation' \
                and _DISPATCH_RE.search(str(ev.get('name', ''))):
            host_lines.setdefault(key, []).append(ev)

    # host dispatch cadence: gaps between successive dispatch events on
    # the line that issued the most of them (the python step loop)
    dispatch_count, gap_us = 0, 0.0
    if host_lines:
        best = max(host_lines.values(), key=len)
        disp = sorted(
            ((float(e['ts']), float(e['ts']) + float(e.get('dur')
                                                     or 0.0))
             for e in best), key=lambda iv: iv[0])
        dispatch_count = len(disp)
        for (_, prev_hi), (lo, _) in zip(disp, disp[1:]):
            gap_us += max(0.0, lo - prev_hi)
    host = {'dispatch_count': dispatch_count,
            'dispatch_gap_ms': round(gap_us / 1e3, 4)}

    # device events define the analysis window; a capture with none is
    # an empty attribution (the caller degrades gracefully)
    all_ops = [ev for evs in lines.values() for ev in evs]
    if not all_ops:
        return {'window_ms': 0.0, 'device_lines': 0, 'events': 0,
                'buckets': {'compute_ms': 0.0, 'comm_ms': 0.0,
                            'comm_exposed_ms': 0.0, 'io_ms': 0.0,
                            'idle_ms': 0.0, 'busy_ms': 0.0},
                'busy_frac': 0.0, 'exposed_comm_frac': 0.0,
                'host': host, 'ops': []}
    w_lo = min(float(ev['ts']) for ev in all_ops)
    w_hi = max(float(ev['ts']) + float(ev.get('dur') or 0.0)
               for ev in all_ops)
    window_us = w_hi - w_lo

    compute_us = comm_us = exposed_us = io_us = 0.0
    busy_us = idle_us = 0.0
    op_table = {}               # base -> [us, count, category]
    for key, evs in lines.items():
        evs.sort(key=lambda e: float(e['ts']))
        comp_iv, io_iv, coll_evs = [], [], []
        for ev in evs:
            name = str(ev['name'])
            lo = float(ev['ts'])
            hi = lo + float(ev.get('dur') or 0.0)
            cat = event_category(ev)
            base = op_base_name(name)
            row = op_table.setdefault(base, [0.0, 0, cat])
            row[0] += hi - lo
            row[1] += 1
            if cat == 'collective':
                coll_evs.append(ev)
            elif cat == 'io':
                io_iv.append((lo, hi))
            else:
                comp_iv.append((lo, hi))
        comp_len, comp_merged = _union(comp_iv)
        io_len, _ = _union(io_iv)
        coll_iv = _pair_async(coll_evs)
        coll_len, coll_merged = _union(coll_iv)
        overlap = _intersection_length(coll_merged, comp_merged)
        # busy uses the PAIRED collective intervals: an async
        # collective in flight (between -start and -done) is busy comm
        # time, not idle — this keeps the invariant
        # compute + io + exposed_comm + idle == window per line
        busy_len, _ = _union(comp_iv + io_iv + coll_iv)
        compute_us += comp_len
        io_us += io_len
        comm_us += coll_len
        exposed_us += max(0.0, coll_len - overlap)
        busy_us += busy_len
        idle_us += max(0.0, window_us - busy_len)

    n_lines = len(lines)

    ops = sorted(
        ({'op': base, 'category': cat, 'ms': round(us / 1e3, 4),
          'count': count}
         for base, (us, count, cat) in op_table.items()),
        key=lambda r: -r['ms'])[:12]
    total_line_us = window_us * n_lines
    return {
        'window_ms': round(window_us / 1e3, 4),
        'device_lines': n_lines,
        'events': len(all_ops),
        'buckets': {
            'compute_ms': round(compute_us / 1e3, 4),
            'comm_ms': round(comm_us / 1e3, 4),
            'comm_exposed_ms': round(exposed_us / 1e3, 4),
            'io_ms': round(io_us / 1e3, 4),
            'idle_ms': round(idle_us / 1e3, 4),
            'busy_ms': round(busy_us / 1e3, 4),
        },
        'busy_frac': round(busy_us / total_line_us, 6)
        if total_line_us > 0 else 0.0,
        'exposed_comm_frac': round(exposed_us / comm_us, 6)
        if comm_us > 0 else 0.0,
        'host': host,
        'ops': ops,
    }


#: torch.profiler's host categories of time spent in torch or CUDA: aten
#: ops (nested ones included) and CUDA runtime and driver calls
_HOST_CALL_CATS = ('cpu_op', 'cuda_runtime', 'cuda_driver')


def host_time_split(events) -> dict:
    """Where the host's time inside the step dispatches goes, from a
    ``torch.profiler`` trace's CPU events (ms, every host thread):

    - ``step_ms``: the dispatches' (``ProfilerStep#N``) summed extent;
    - ``op_ms``: the part in which some thread is inside an aten op or a
      CUDA runtime or driver call; ``python_ms`` the rest, when no thread
      is (Python between ops, ctypes calls outside any op);
    - ``launches`` / ``launch_ms``: the kernel-launch calls and their
      time; ``sync_count`` / ``sync_ms``: the calls that wait for the
      card (``*Synchronize``, a blocking ``cudaMemcpy``).

    Zeros for a trace without dispatches or CPU events (a JAX one)."""
    steps, calls = [], []
    dispatch_lines = {}
    for ev in events:
        if ev.get('ph') != 'X' or ev.get('ts') is None:
            continue
        lo = float(ev['ts'])
        iv = (lo, lo + float(ev.get('dur') or 0.0), str(ev.get('name', '')))
        if ev.get('cat') in _HOST_CALL_CATS:
            calls.append(iv)
        elif ev.get('cat') not in TORCH_DEVICE_CATS \
                and ev.get('cat') != 'gpu_user_annotation' \
                and _DISPATCH_RE.search(iv[2]):
            dispatch_lines.setdefault((ev.get('pid'), ev.get('tid')),
                                      []).append(iv[:2])
    if dispatch_lines:
        steps = max(dispatch_lines.values(), key=len)
    step_us, merged_steps = _union(steps)

    def inside(ivs):
        return [(max(lo, s_lo), min(hi, s_hi)) for lo, hi in ivs
                for s_lo, s_hi in merged_steps if lo < s_hi and s_lo < hi]

    op_us, _ = _union(inside([c[:2] for c in calls]))
    launch = inside([c[:2] for c in calls if 'LaunchKernel' in c[2]])
    sync = inside([c[:2] for c in calls if 'Synchronize' in c[2]
                   or c[2] in ('cudaMemcpy', 'cuMemcpyDtoH_v2')])
    return {'steps': len(steps), 'step_ms': round(step_us / 1e3, 4),
            'op_ms': round(op_us / 1e3, 4),
            'python_ms': round((step_us - op_us) / 1e3, 4),
            'launches': len(launch),
            'launch_ms': round(sum(hi - lo for lo, hi in launch) / 1e3, 4),
            'sync_count': len(sync),
            'sync_ms': round(sum(hi - lo for lo, hi in sync) / 1e3, 4)}


def read_trace_events(path: str) -> list:
    """The ``traceEvents`` array of one ``*.trace.json[.gz]`` file."""
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as fh:
        data = json.load(fh)
    events = data.get('traceEvents') if isinstance(data, dict) else data
    if not isinstance(events, list):
        raise ValueError(f'{path}: no traceEvents array')
    return events


def parse_trace_file(path: str) -> dict:
    """Attribution from one ``*.trace.json[.gz]`` file."""
    out = parse_trace_events(read_trace_events(path))
    out['source'] = path
    return out


def find_trace_files(root: str):
    """The trace files of the NEWEST capture under ``root``, laid out as
    ``root/plugins/profile/<timestamp>/*.trace.json.gz`` (one file per
    host: jax's layout, which the port's tracers write too); a bare
    directory of trace files also works."""
    capture_root = os.path.join(root, 'plugins', 'profile')
    if os.path.isdir(capture_root):
        stamps = sorted(
            (d for d in glob.glob(os.path.join(capture_root, '*'))
             if os.path.isdir(d)),
            key=os.path.getmtime)
        if stamps:
            root = stamps[-1]
    files = sorted(glob.glob(os.path.join(root, '*.trace.json.gz'))
                   + glob.glob(os.path.join(root, '*.trace.json')))
    return files


def parse_trace_dir(root: str) -> dict:
    """Attribution for the newest capture under ``root``, summed across
    per-host trace files (fractions recomputed over the sums)."""
    files = find_trace_files(root)
    if not files:
        raise FileNotFoundError(f'no *.trace.json[.gz] under {root}')
    parts = [parse_trace_file(p) for p in files]
    if len(parts) == 1:
        return parts[0]
    out = parts[0]
    for p in parts[1:]:
        for k, v in p['buckets'].items():
            out['buckets'][k] = round(out['buckets'][k] + v, 4)
        out['device_lines'] += p['device_lines']
        out['events'] += p['events']
        out['window_ms'] = max(out['window_ms'], p['window_ms'])
        out['host']['dispatch_count'] += p['host']['dispatch_count']
        out['host']['dispatch_gap_ms'] = round(
            out['host']['dispatch_gap_ms']
            + p['host']['dispatch_gap_ms'], 4)
    merged_ops = {}
    for p in parts:
        for row in p['ops']:
            agg = merged_ops.setdefault(
                row['op'], {'op': row['op'],
                            'category': row['category'],
                            'ms': 0.0, 'count': 0})
            agg['ms'] = round(agg['ms'] + row['ms'], 4)
            agg['count'] += row['count']
    out['ops'] = sorted(merged_ops.values(),
                        key=lambda r: -r['ms'])[:12]
    total = out['window_ms'] * out['device_lines']
    out['busy_frac'] = round(
        out['buckets']['busy_ms'] / total, 6) if total > 0 else 0.0
    comm = out['buckets']['comm_ms']
    out['exposed_comm_frac'] = round(
        out['buckets']['comm_exposed_ms'] / comm, 6) if comm > 0 \
        else 0.0
    out['source'] = os.path.dirname(files[0])
    return out


__all__ = ['COLLECTIVE_PREFIXES', 'IO_PREFIXES', 'TORCH_DEVICE_CATS',
           'classify_op', 'event_category',
           'op_base_name', 'parse_trace_events', 'parse_trace_file',
           'parse_trace_dir', 'find_trace_files', 'host_time_split',
           'read_trace_events']
