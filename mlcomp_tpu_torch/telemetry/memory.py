"""Memory timeline, step memory attribution and the failure flight
recorder (port of ``mlcomp_tpu/telemetry/memory.py``).

- **timeline** — ``MemorySampler`` records ``device<i>.hbm_used`` /
  ``hbm_limit`` / ``hbm_peak`` as per-step series from the caching
  allocator (one allocator read a step on the card, no device sync; the
  card's total memory is read once). On the CPU it is inert.
- **step attribution** — with no compiled executable to ask,
  ``memory_attribution`` takes the first instrumented step's bytes: the
  arguments (the train state and the batch), the temporaries (the
  step's peak allocation above its start) and no generated code. One
  ``memory.attribution`` row, the split in the tags, as the JAX
  package writes it.
- **flight recorder** — ``build_postmortem`` assembles, from rows
  already in the DB, the bundle an operator needs after the crash: the
  last ``tail`` steps of the loss / step-time / phase / memory /
  compile / devtime series, the run snapshot, the memory attribution,
  and the task's alerts. ``TaskProvider.fail_with_reason`` freezes it
  on every reasoned failure (the ``postmortem`` table, migration v10),
  for ``python -m mlcomp_tpu_torch postmortem <task>`` and
  ``/api/task/postmortem``.
"""

import json

#: series the postmortem bundle tails (prefix match), newest-first in
#: the stored bundle — the signals that explain an OOM or a slow death
POSTMORTEM_SERIES_PREFIXES = (
    'loss', 'step_time_ms', 'throughput', 'step.phase.',
    'step.pipeline_efficiency', 'device', 'compile.backend_ms',
    'comm.', 'mfu', 'host_sync.suspect_ms', 'devtime.',
)

#: single-row context signals carried whole (latest row, tags decoded)
#: — devtime.summary is the newest sampled device-time window
#: (telemetry/deviceprof.py), so an OOM/stall postmortem shows what
#: the device was actually doing
POSTMORTEM_CONTEXT_NAMES = ('run.snapshot', 'memory.attribution',
                            'comm.bytes_per_step', 'devtime.summary')


class MemorySampler:
    """Per-step memory timeline recorder. Construct once per training
    loop with the loop's ``device``; ``sample(step)`` emits one
    used/limit/peak triple per card into the recorder's buffer (no
    device sync, no DB write). Inert unless ``device`` is a CUDA device;
    ``every`` thins the timeline."""

    def __init__(self, recorder, every: int = 1, device=None):
        self.recorder = recorder
        self.every = max(1, int(every))
        self.platform = None
        self._devices = []       # [(index, total bytes)]
        if device is None or getattr(device, 'type', device) != 'cuda':
            return
        from mlcomp_tpu_torch.telemetry.device import _total_memory
        import torch
        index = device.index if getattr(device, 'index', None) is not None \
            else torch.cuda.current_device()
        self.platform = 'gpu'
        self._devices = [(int(index), _total_memory(int(index)))]

    @property
    def active(self) -> bool:
        return bool(self._devices)

    def sample(self, step: int = None):
        """Record one timeline point: one allocator read a card."""
        if not self._devices:
            return
        if step is not None and step % self.every:
            return
        from mlcomp_tpu_torch.telemetry.device import cuda_memory
        rec = self.recorder
        for index, limit in self._devices:
            used, peak = cuda_memory(index)
            rec.series(f'device{index}.hbm_used', float(used), step=step)
            rec.series(f'device{index}.hbm_limit', float(limit),
                       step=step)
            if peak:
                rec.series(f'device{index}.hbm_peak', float(peak),
                           step=step)


# -------------------------------------------------------- step attribution
def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (nested dicts, lists, tuples
    and objects with ``state_dict``), each storage counted once."""
    seen, total = set(), 0

    def walk(node):
        nonlocal total
        if node is None:
            return
        if hasattr(node, 'untyped_storage') and hasattr(node, 'numel'):
            key = (node.device, node.untyped_storage().data_ptr())
            if key not in seen:
                seen.add(key)
                total += node.untyped_storage().nbytes()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif hasattr(node, 'state_dict'):
            walk(node.state_dict(keep_vars=True))

    for tree in trees:
        walk(tree)
    return total


def memory_attribution(argument_bytes: int, temp_bytes: int = None) -> dict:
    """The JAX module's peak split for one step that ran: ``arguments``
    (state and batch), ``temp`` (its peak allocation above the start;
    None where the allocator has no peak, the CPU: then left out), no
    outputs beyond the in-place state and no generated code."""
    out = {'argument_bytes': int(argument_bytes), 'output_bytes': 0,
           'generated_code_bytes': 0, 'alias_bytes': 0}
    if temp_bytes is not None:
        out['temp_bytes'] = max(0, int(temp_bytes))
    out['total_bytes'] = out['argument_bytes'] + out.get('temp_bytes', 0)
    return out


def persist_memory_attribution(session, task_id: int,
                               attribution: dict, stage: str = None,
                               component: str = 'train') -> bool:
    """One ``memory.attribution`` row per run: value is the
    static peak total, the full split rides the tags (the shape the
    postmortem bundle and the dashboard memory card read)."""
    if not attribution:
        return False
    from mlcomp_tpu_torch.db.providers.telemetry import MetricProvider
    from mlcomp_tpu_torch.utils.misc import now
    tags = dict(attribution)
    if stage is not None:
        tags['stage'] = stage
    MetricProvider(session).add_many([(
        task_id, 'memory.attribution', 'gauge', None,
        float(attribution.get('total_bytes', 0)), now(), component,
        json.dumps(tags))])
    return True


def persist_run_snapshot(session, task_id: int, snapshot: dict,
                         component: str = 'train') -> bool:
    """One ``run.snapshot`` row carrying the mesh / sharding / batch
    shape / model identity of the live run — the context half of the
    postmortem bundle (series say WHAT happened, this says on what)."""
    if not snapshot:
        return False
    from mlcomp_tpu_torch.db.providers.telemetry import MetricProvider
    from mlcomp_tpu_torch.utils.misc import now
    MetricProvider(session).add_many([(
        task_id, 'run.snapshot', 'gauge', None, 0.0, now(), component,
        json.dumps(snapshot))])
    return True


# ---------------------------------------------------- flight recorder
def build_postmortem(session, task_id: int, tail: int = 50) -> dict:
    """Assemble the postmortem bundle for one task from rows already
    in the DB (the crash-time flush ran before the failure path marks
    the task, so the series end at the death). Works for failures the
    task's own process never saw (worker-lost, lease-expired): the
    supervisor-side caller has the same DB."""
    from mlcomp_tpu_torch.db.providers.telemetry import (
        AlertProvider, MetricProvider,
    )
    metrics = MetricProvider(session)
    series = {}
    for name in metrics.names(task_id):
        if not any(name == p or name.startswith(p)
                   for p in POSTMORTEM_SERIES_PREFIXES):
            continue
        rows = session.query(
            'SELECT step, value, time FROM metric '
            'WHERE task=? AND name=? ORDER BY id DESC LIMIT ?',
            (int(task_id), name, int(tail)))
        series[name] = [
            {'step': r['step'], 'value': r['value'], 'time': r['time']}
            for r in reversed(rows)]
    context = {}
    for name in POSTMORTEM_CONTEXT_NAMES:
        row = session.query_one(
            'SELECT value, tags FROM metric WHERE task=? AND name=? '
            'ORDER BY id DESC LIMIT 1', (int(task_id), name))
        if row is None:
            continue
        tags = None
        try:
            tags = json.loads(row['tags']) if row['tags'] else None
        except ValueError:
            pass
        context[name] = {'value': row['value'], 'tags': tags}
    alerts = [{'rule': a.rule, 'severity': a.severity,
               'message': a.message, 'time': str(a.time)}
              for a in AlertProvider(session).get(
                  status=None, task=task_id, limit=20)]
    row = session.query_one(
        'SELECT name, status, failure_reason, attempt, '
        'computer_assigned, additional_info FROM task WHERE id=?',
        (int(task_id),))
    task_card = {}
    if row is not None:
        task_card = {'name': row['name'], 'status': row['status'],
                     'failure_reason': row['failure_reason'],
                     'attempt': row['attempt'] or 0,
                     'computer': row['computer_assigned']}
        # the mesh/distr context the supervisor stamped on dispatch —
        # the sharding half of the snapshot for fanned-out ranks
        try:
            from mlcomp_tpu_torch.utils.io import yaml_load
            info = yaml_load(row['additional_info']) \
                if row['additional_info'] else {}
            distr = (info or {}).get('distr_info') or {}
            if distr.get('mesh'):
                task_card['mesh'] = distr['mesh']
            if 'process_index' in distr:
                task_card['rank'] = distr.get('process_index')
        except Exception:
            pass
    return {'task': int(task_id), 'tail': int(tail),
            'task_card': task_card, 'series': series,
            'context': context, 'alerts': alerts}


#: bundles retained per task — retries append, the newest wins, and
#: older ones past this depth are pruned on insert so a flapping task
#: cannot grow the table one multi-KB bundle per failure forever
POSTMORTEM_KEEP_PER_TASK = 5


def persist_postmortem(session, task_id: int, reason: str = None,
                       tail: int = 50):
    """Build + freeze the bundle into the ``postmortem`` table (one
    row per failure event — retries append new rows; consumers read
    the newest, rows past ``POSTMORTEM_KEEP_PER_TASK`` are pruned).
    Never raises: the flight recorder must not break the failure path
    it rides."""
    try:
        from mlcomp_tpu_torch.db.models import Postmortem
        from mlcomp_tpu_torch.db.providers.telemetry import PostmortemProvider
        from mlcomp_tpu_torch.utils.misc import now
        bundle = build_postmortem(session, task_id, tail=tail)
        row = Postmortem(task=int(task_id), created=now(),
                         reason=reason, data=json.dumps(bundle))
        provider = PostmortemProvider(session)
        provider.add(row)
        provider.prune(task_id, keep=POSTMORTEM_KEEP_PER_TASK)
        return row
    except Exception:
        return None


def load_postmortem(session, task_id: int):
    """Newest frozen bundle of a task (decoded dict with ``created``/
    ``reason`` stamps), or None."""
    from mlcomp_tpu_torch.db.providers.telemetry import PostmortemProvider
    row = PostmortemProvider(session).latest(task_id)
    if row is None:
        return None
    try:
        bundle = json.loads(row.data) if row.data else {}
    except ValueError:
        bundle = {}
    bundle['created'] = str(row.created)
    bundle['reason'] = row.reason
    bundle['postmortem_id'] = row.id
    return bundle


__all__ = ['MemorySampler', 'memory_attribution', 'tensor_bytes',
           'persist_memory_attribution', 'persist_run_snapshot',
           'build_postmortem', 'persist_postmortem', 'load_postmortem',
           'POSTMORTEM_SERIES_PREFIXES', 'POSTMORTEM_CONTEXT_NAMES']
