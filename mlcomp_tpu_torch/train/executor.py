"""The training executor — port of ``mlcomp_tpu/train/executor.py``
``JaxTrain``, registered under the snake key ``train``.

Example spec (the JAX trainer's keys, plus ``device``)::

    train:
      type: train
      model: {name: transformer_lm, vocab_size: 32768, dtype: bfloat16}
      dataset: {name: npz, path: tokens.npz}
      loss: lm_ce
      batch_size: 1
      stages:
        - {name: stage1, epochs: 1,
           optimizer: {name: adamw, lr: 3e-4,
                       schedule: {name: warmup_cosine}}}
      main_metric: loss
      minimize: true
      checkpoint_dir: /path/to/checkpoints
      model_name: my_lm        # export to models/my_lm (working dir)
      device: cuda             # the card unless the caller asks for cpu

Ported: stages and epochs, the train and eval loops over the host
pipeline (batches augmented on the host by ``augment``'s
``contrib/transform`` pipeline, pinned and copied ahead of the step) or,
with ``device_data`` (``auto``, the default, or ``true``), over a
dataset resident on the device with on-device ``augment``
(``device_data.py``; the JAX trainer's selection rule),
``main_metric`` / ``minimize`` best tracking, ``checkpoint_every``, the
async checkpoint writer, resume through ``resume_plan``,
``stage_per_dispatch`` (one stage a dispatch, the next named in the
task's ``additional_info``), running statistics (``batch_stats``) in
checkpoints and the export, the ``model_name`` export, pretrained
weights (``model.params_file``, ``train/pretrained.py``; a resume wins
over them) and ``infer_valid`` (the validation set's predictions under
``data/pred``, the best checkpoint's by default). ``mesh`` may
be ``{dp: 1}`` or ``{dp: -1}`` ("every device") on one device. Run by
the task pipeline (a DB session and a task), it writes the JAX
trainer's rows: ``ReportSeries`` of every train and valid metric and
``images_per_sec`` each epoch, ``task.score`` and the model's
``score_local``, a ``train.work`` span with ``train.epoch`` children and
the device telemetry of the JAX trainer (``telemetry: true`` by default,
or a dict of its keys: ``flush_every``, ``memory_every``,
``profile_every``, ``profile_steps``, ``cost_analysis``,
``memory_analysis``, ``peak_tflops``): per-step ``loss``,
``step_time_ms``, ``throughput`` and ``step.phase.*_ms``, the memory
timeline ``device<i>.hbm_*`` on the card, sampled ``torch.profiler``
windows as ``devtime.*`` (where ``profile_every`` asks: off by default),
``run.snapshot``, ``memory.attribution`` and the first step's FLOPs
(both by default on the card only), and per epoch ``epoch_time_s``,
``epoch_throughput``, ``mfu`` (over 989 TFLOP/s unless ``peak_tflops``
or ``MLCOMP_PEAK_TFLOPS`` says otherwise) and
``step.pipeline_efficiency``; ``/api/telemetry/profile`` traces
epochs on demand and ``profile: {epochs, dir}`` traces the given
ones. Checkpoints go to ``TASK_FOLDER/<task>/checkpoints`` and the
export to ``MODEL_FOLDER/<project>/<model_name>``. Keys
whose feature is not ported yet raise ``NotImplementedError`` with
their ROADMAP.md item; unknown keys are logged as the JAX trainer logs
them.
"""

import os
import time

import numpy as np
import torch

from mlcomp_tpu_torch.contrib.transform import parse_transforms
from mlcomp_tpu_torch.convert import (
    jax_kernel_shapes, state_dict_from_jax, variables_to_jax,
)
from mlcomp_tpu_torch.models import create_model, param_count
from mlcomp_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter, checkpoint_exists, load_meta, restore_checkpoint,
    resume_plan, save_checkpoint,
)
from mlcomp_tpu_torch.train.data import (
    create_dataset, iterate_batches, place_batch, prefetch_batches,
)
from mlcomp_tpu_torch.train.device_data import (
    DEVICE_AUGMENTS, dataset_fits_hbm, make_device_augment,
    normalize_augment_spec, place_dataset, quantize_dataset,
)
from mlcomp_tpu_torch.testing.faults import fault_point
from mlcomp_tpu_torch.train.loop import (
    aggregate_metrics, create_train_state, instrumented_step, loss_for_task,
    make_device_eval_step, make_device_train_step, make_eval_step,
    make_train_step,
)
from mlcomp_tpu_torch.train.optim import (
    make_optimizer, state_to_device, state_to_host,
)
from mlcomp_tpu_torch.utils.device import resolve_device
from mlcomp_tpu_torch.worker.executors import Executor

#: constructor keys whose feature is not ported yet -> ROADMAP.md item
_NOT_PORTED = {
    'epoch_scan': 'A0 (one dispatch per epoch)',
    'report_imgs': 'A0: report images are encoded with OpenCV and '
                   'matplotlib, which the card\'s machine has not shown '
                   '(an encoder without them, or OpenCV on the card)',
}


def _not_ported(key: str):
    raise NotImplementedError(
        f'train: {key!r} is not ported yet (ROADMAP.md, {_NOT_PORTED[key]})')


def _same_structure(a, b) -> bool:
    """Do two states (nested dicts of tensors/arrays and ints) have the
    same keys, leaf kinds and shapes?"""
    if isinstance(a, dict) or isinstance(b, dict):
        return isinstance(a, dict) and isinstance(b, dict) \
            and a.keys() == b.keys() \
            and all(_same_structure(a[k], b[k]) for k in a)
    if hasattr(a, 'shape') or hasattr(b, 'shape'):
        return hasattr(a, 'shape') and hasattr(b, 'shape') \
            and tuple(a.shape) == tuple(b.shape)
    return type(a) is type(b) or a is None or b is None


@Executor.register
class Train(Executor):
    def __init__(self, model=None, dataset=None, loss='softmax_ce',
                 batch_size=32, eval_batch_size=None, mesh=None,
                 stages=None, epochs=1, optimizer=None,
                 main_metric='accuracy', minimize=False,
                 model_name=None, seed=0, checkpoint_dir=None,
                 stage_per_dispatch=False, log_every=50,
                 report_imgs=None, augment=None, prefetch=2,
                 device_data='auto', epoch_scan=False,
                 checkpoint_every=1, infer_valid=None, profile=None,
                 async_checkpoint=True, telemetry=True, device='cuda',
                 **kwargs):
        self.model_spec = dict(model or {'name': 'mlp'})
        # pretrained init (train/pretrained.py): popped, so create_model
        # and the export's spec see architecture keys only
        self.params_file = self.model_spec.pop('params_file', None)
        # {dp: -1} is "every device": one here, unless CUDA shows more
        if mesh is not None and (
                dict(mesh) not in ({'dp': 1}, {'dp': -1})
                or (dict(mesh) == {'dp': -1}
                    and torch.cuda.device_count() > 1)):
            raise NotImplementedError(
                f'train: mesh {mesh!r} is not ported yet (ROADMAP.md, queue '
                f'A: A4 parallel and distributed); the port trains on one '
                f'device (mesh: null, {{dp: 1}}, or {{dp: -1}} where one '
                f'device is visible)')
        if device_data not in (True, False, 'auto'):
            raise ValueError(f"device_data must be true, false or 'auto', "
                             f'got {device_data!r}')
        for key, value in (('epoch_scan', epoch_scan),
                           ('report_imgs', report_imgs)):
            if value:
                _not_ported(key)
        self.dataset_spec = dict(dataset or {})
        self.loss_spec = dict(loss) if isinstance(loss, dict) else loss
        self.loss_name = loss.get('name') if isinstance(loss, dict) \
            else loss
        self.batch_size = int(batch_size)
        self.eval_batch_size = int(eval_batch_size or batch_size)
        self.stages = [dict(s) for s in (stages or [])] or [
            {'name': 'stage1', 'epochs': int(epochs),
             'optimizer': optimizer or {'name': 'adam', 'lr': 1e-3}}]
        self.main_metric = main_metric
        self.minimize = bool(minimize)
        self.model_name = model_name
        self.seed = int(seed)
        self.checkpoint_dir = checkpoint_dir
        self.prefetch = int(prefetch)
        self.augment = list(augment) if augment else None
        self.device_data = device_data
        self.checkpoint_every = int(checkpoint_every)
        if self.checkpoint_every == 0:
            wants_best = bool(infer_valid) and \
                bool(dict(infer_valid).get('best_only', True))
            if stage_per_dispatch or model_name or wants_best:
                raise ValueError(
                    'checkpoint_every: 0 disables saving, but '
                    'stage_per_dispatch requeue, model_name export, '
                    'and infer_valid best_only (its default) all read '
                    'checkpoint files — drop one, or set '
                    'infer_valid: {best_only: false}')
        # {'out_prefix': str, 'best_only': bool}: the validation set's
        # softmax predictions saved under data/pred after training
        self.infer_valid = dict(infer_valid) if infer_valid else None
        self.async_checkpoint = bool(async_checkpoint)
        self.stage_per_dispatch = bool(stage_per_dispatch)
        # {'epoch': N | 'epochs': [..], 'dir': path}: a torch.profiler
        # trace of the given global epoch(s)
        self.profile = dict(profile) if profile else None
        # telemetry: True (default) | False | a dict of the JAX keys
        self.telemetry_spec = dict(telemetry) \
            if isinstance(telemetry, dict) else ({} if telemetry else None)
        self.device = device
        # leftover config keys: logged loudly by _work, not an error
        self._unknown_kwargs = sorted(kwargs)

    # ------------------------------------------------------------ plumbing
    def _checkpoint_folder(self):
        if self.checkpoint_dir:
            return self.checkpoint_dir
        from mlcomp_tpu_torch import TASK_FOLDER
        task_id = self.task.id if self.task else 0
        # the service tasks of one distributed job share the parent's
        if self.task is not None and self.task.parent:
            task_id = self.task.parent
        return os.path.join(TASK_FOLDER, str(task_id), 'checkpoints')

    def _model_folder(self):
        """``MODEL_FOLDER/<project>`` for a task of a DAG, else
        ``models`` under the working directory."""
        if self.dag is not None and self.session is not None:
            from mlcomp_tpu_torch import MODEL_FOLDER
            from mlcomp_tpu_torch.db.providers import ProjectProvider
            project = ProjectProvider(self.session).by_id(self.dag.project)
            if project is not None:
                return os.path.join(MODEL_FOLDER, project.name)
        return 'models'

    def _tracked(self) -> bool:
        """Does this run write the task's DB rows (a session and a
        task)?"""
        return self.session is not None and self.task is not None

    def _report_series(self, name, value, epoch, part, stage):
        if not self._tracked():
            return
        from mlcomp_tpu_torch.db.models import ReportSeries
        from mlcomp_tpu_torch.db.providers import ReportSeriesProvider
        from mlcomp_tpu_torch.utils.misc import now
        ReportSeriesProvider(self.session).add(ReportSeries(
            task=self.task.id, time=now(), epoch=int(epoch),
            value=float(value), name=name, part=part, stage=stage))

    def _update_scores(self, score):
        """task.score and the Model row's score_local, best so far."""
        if not self._tracked():
            return
        from mlcomp_tpu_torch.db.providers import ModelProvider, TaskProvider
        better = (self.task.score is None or
                  (score < self.task.score if self.minimize
                   else score > self.task.score))
        if better:
            self.task.score = float(score)
            TaskProvider(self.session).update(self.task, ['score'])
            if self.model_name:
                from mlcomp_tpu_torch.db.models import Model
                from mlcomp_tpu_torch.utils.misc import now
                provider = ModelProvider(self.session)
                row = provider.by_name(self.model_name)
                if row is None:
                    row = Model(
                        name=self.model_name, project=self.dag.project,
                        dag=self.dag.id, created=now())
                row.score_local = float(score)
                provider.create_or_update(row, 'name')

    def _host_tree(self, state) -> dict:
        """A host copy of the train state in the checkpoint layout:
        ``params`` (and ``batch_stats``, where the model keeps running
        statistics) in the JAX layout, ``opt_state`` in the port's."""
        return {'step': int(state.step),
                **variables_to_jax(state.model),
                'opt_state': state_to_host(state.opt_state),
                'rng': state.rng}

    def _fitting_state_dict(self, tree, model) -> dict:
        """The port state dict of a checkpoint tree's ``params`` (and
        ``batch_stats``); raise unless it has ``model``'s keys and shapes
        (checked before anything loads)."""
        sd = state_dict_from_jax(tree, self.model_spec['name'])
        current = model.state_dict()
        if sd.keys() != current.keys() or any(
                sd[k].shape != current[k].shape for k in sd):
            raise ValueError('checkpoint params do not fit the model')
        return sd

    def _restore_into(self, state, device):
        """``restore_checkpoint``'s target: check that a checkpoint tree
        fits ``state`` (raise if not), then load it in place."""
        def target(tree):
            sd = self._fitting_state_dict(tree, state.model)
            opt = state_to_device(tree['opt_state'], device)
            if not _same_structure(opt, state.opt_state):
                raise ValueError('checkpoint optimizer state does not fit '
                                 'the optimizer')
            state.model.load_state_dict(sd)
            state.opt_state = opt
            state.step = int(tree['step'])
            rng = tree.get('rng')
            state.rng = None if rng is None else int(rng)
            return state
        return target

    # ---------------------------------------------------------------- work
    def work(self):
        self._ckpt_writer = AsyncCheckpointWriter() \
            if self.async_checkpoint else None
        # the telemetry objects _work builds with a session and a task;
        # closed here whatever happens
        self._telemetry = None
        self._profiler = None
        self._deviceprof = None
        self._attribution = None
        self._compile_events = None
        self._profile_tracer = None
        # the train loop's leg of the task's trace (a ``train.work`` root
        # with ``train.epoch`` children)
        span_cm = None
        if self.telemetry_spec is not None and self._tracked():
            from mlcomp_tpu_torch.telemetry import span
            info = dict(getattr(self, 'additional_info', None) or {})
            span_cm = span('train.work', task=self.task.id, role='train',
                           trace_id=info.get('trace_id') or None,
                           tags={'model': self.model_spec.get('name')})
            span_cm.__enter__()
        ok = False
        try:
            result = self._work()
            ok = True
            return result
        finally:
            if span_cm is not None:
                import sys
                try:
                    span_cm.__exit__(*sys.exc_info())
                except BaseException:
                    pass       # the span re-raises the active error
                from mlcomp_tpu_torch.telemetry import flush_spans
                flush_spans(self.session)
            self._close_telemetry()
            writer, self._ckpt_writer = self._ckpt_writer, None
            if writer is not None:
                try:
                    writer.close()
                except Exception as e:
                    self.error(f'checkpoint writer: {e}')
                    if ok:
                        raise

    def _close_telemetry(self):
        """Teardown, in the JAX trainer's order: the build listener goes
        (a persistent worker's next task must not record into this one),
        the on-demand trace stops, an open sampled window stops and
        parses (its devtime rows land even on the failure path, and
        Kineto is free for the next profiler), the recorder flushes, an
        epoch trace left open by an exception stops."""
        for obj, method in ((self._compile_events, 'uninstall'),
                            (self._profiler, 'close'),
                            (self._deviceprof, 'close'),
                            (self._telemetry, 'close')):
            if obj is not None:
                try:
                    getattr(obj, method)()
                except Exception:
                    pass
        tracer, self._profile_tracer = self._profile_tracer, None
        if tracer is not None:
            try:
                tracer.stop()
            except Exception:
                pass

    def _start_telemetry(self, device, ck_dir):
        """The recorder and its hooks, with a session and a task only
        (one writer per task), as the JAX trainer builds them."""
        from mlcomp_tpu_torch.telemetry import (
            CompileEventRecorder, DeviceProfiler, HostSyncTripwire,
            MemorySampler, MetricRecorder, StepAttribution, TaskProfiler,
        )
        from mlcomp_tpu_torch.telemetry.device import FirstStepProbe
        from mlcomp_tpu_torch.telemetry.deviceprof import DEFAULT_WINDOW
        spec = self.telemetry_spec
        on_card = device.type == 'cuda'
        # async_flush: the window-full flush (the device pull and the DB
        # write) runs on a background thread, never inside the step
        self._telemetry = MetricRecorder(
            session=self.session, task=self.task.id, component='train',
            async_flush=True, flush_every=int(spec.get('flush_every', 100)))
        self._profiler = TaskProfiler(self.session, self.task.id, ck_dir,
                                      cuda=on_card)
        self._attribution = StepAttribution(recorder=self._telemetry)
        self._tripwire = HostSyncTripwire(recorder=self._telemetry)
        self._compile_events = CompileEventRecorder(
            recorder=self._telemetry)
        self._compile_events.install()
        self._memory = MemorySampler(
            self._telemetry, every=int(spec.get('memory_every', 1)),
            device=device)
        # cost_analysis / memory_analysis: the first step's FLOPs and
        # bytes, by default on the card only, as the JAX trainer's
        # introspection defaults on off-CPU only (the count costs the
        # first step 0.1 s on the card, telemetry/device.py)
        self._probe = FirstStepProbe(
            flops=bool(spec.get('cost_analysis', on_card)),
            memory=bool(spec.get('memory_analysis', on_card)),
            device=device)
        self._probe_reported = False
        # sampled device-time windows: only where profile_every asks.
        # Unlike the JAX trainer's, they are off by default on the card
        # too: a process's first torch.profiler window starts in seconds
        # and each window's close holds the loop for 0.5-1.2 s (PERF.md)
        every = int(spec.get('profile_every', 0))
        if every > 0:
            self._deviceprof = DeviceProfiler(
                self.session, self.task.id, every=every,
                window=int(spec.get('profile_steps', DEFAULT_WINDOW)),
                logger=self.info, cuda=on_card,
                blocked=lambda: self._profile_tracer is not None
                or self._profiler.tracing)

    def _report_probe(self):
        """Log and persist the first step's FLOPs and memory once."""
        probe = self._probe
        if self._probe_reported or not probe.done:
            return
        self._probe_reported = True
        if probe.flops is not None:
            self.info(f'telemetry: the first step counted '
                      f'{probe.flops / 1e9:.3f} GFLOP in '
                      f'{probe.seconds:.3f} s')
        if probe.attribution:
            from mlcomp_tpu_torch.telemetry import persist_memory_attribution
            try:
                persist_memory_attribution(self.session, self.task.id,
                                           probe.attribution)
            except Exception:
                pass        # context is best-effort, never fatal
            self.info('memory attribution (first step): ' + ', '.join(
                f'{k.replace("_bytes", "")}={v / 1e9:.2f} GB'
                for k, v in sorted(probe.attribution.items())))

    def _maybe_start_profile(self, global_epoch, ck_dir, device) -> bool:
        """Start a torch.profiler trace if this epoch is in the
        ``profile`` spec."""
        if not self.profile:
            return False
        epochs = self.profile.get('epochs')
        if epochs is None:
            epochs = self.profile.get('epoch', 0)
        if not isinstance(epochs, (list, tuple, set)):
            epochs = [epochs]
        if global_epoch not in {int(e) for e in epochs}:
            return False
        from mlcomp_tpu_torch.telemetry import TorchTracer
        out = self.profile.get('dir') or os.path.join(ck_dir, 'profile')
        tracer = TorchTracer(cuda=device.type == 'cuda')
        try:
            tracer.start(out)
        except Exception as e:  # another profiler runs
            self.info(f'profiler: could not start trace ({e})')
            return False
        self._profile_tracer = tracer
        return True

    def _stop_profile(self, global_epoch):
        tracer, self._profile_tracer = self._profile_tracer, None
        try:
            path = tracer.stop()
            self.info(f'profiler: epoch {global_epoch} device trace -> '
                      f'{path} (Chrome trace format)')
        except Exception as e:
            self.info(f'profiler: stop_trace failed ({e})')

    def _drain_ckpt_writer(self):
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()

    def _work(self):
        t_start = time.time()
        if self._unknown_kwargs:
            self.info(
                f'WARNING: config keys {self._unknown_kwargs} match '
                f'nothing in train — a typo, or a grid-cell key whose '
                f'suffix path does not reach the spec (lists like stages: '
                f'are opaque to the merge)')
        device = resolve_device(self.device)
        loss_fn = loss_for_task(self.loss_spec)
        self_supervised = self.loss_name == 'lm_ce'

        data = create_dataset(**self.dataset_spec) \
            if self.dataset_spec.get('name') else \
            create_dataset('synthetic_images')
        x_train, y_train = data['x_train'], data['y_train']
        x_valid, y_valid = data['x_valid'], data['y_valid']

        # input path, the JAX trainer's rule: the dataset resident on the
        # device with on-device augmentation when every augment is one the
        # device runs, the data is labelled and both splits fit; else the
        # host pipeline
        device_augs = normalize_augment_spec(self.augment)
        if self.device_data is True and device_augs is None:
            raise ValueError(
                f'device_data: true but augment={self.augment!r} has '
                f'transforms outside the device-expressible set '
                f'{DEVICE_AUGMENTS}; drop them or use device_data: auto')
        if self.device_data is True and (y_train is None or self_supervised):
            raise ValueError(
                'device_data: true supports labeled datasets only — '
                'label-less/self-supervised training uses the host '
                'pipeline (device_data: auto selects it automatically)')
        use_device_data = (
            self.device_data is True
            or (self.device_data == 'auto' and device_augs is not None
                and y_train is not None and not self_supervised
                and dataset_fits_hbm(x_train, extra_bytes=x_valid.nbytes)))
        transform = None
        if use_device_data:
            x_q, dequant = quantize_dataset(x_train)
            x_all, y_all = place_dataset(x_q, y_train, device)
            xv_q, dequant_v = quantize_dataset(x_valid)
            xv_all, yv_all = place_dataset(xv_q, y_valid, device)
            dev_augment = make_device_augment(
                device_augs, x_train.shape[1:]) if device_augs else None
        elif self.augment:
            # the host pipeline augments each batch (contrib/transform)
            transform = parse_transforms(self.augment)

        ck_dir = self._checkpoint_folder()
        steps_per_epoch = max(1, len(x_train) // self.batch_size)
        if self.telemetry_spec is not None and self._tracked():
            self._start_telemetry(device, ck_dir)

        def stage_opt_spec(stage):
            return stage.get('optimizer') or \
                self.stages[0].get('optimizer')

        def stage_steps(stage):
            return int(stage.get('epochs', 1)) * steps_per_epoch

        # stage per dispatch: the task's additional_info names the stage
        # this dispatch runs (the pipeline stores the next one)
        info = dict(getattr(self, 'additional_info', None) or {})
        dispatch_stage = info.get('stage') if self.stage_per_dispatch \
            else None
        stage_names = [s['name'] for s in self.stages]
        # the restore target's optimizer is the one of the stage that
        # saved the checkpoint, not stages[0]
        meta = load_meta(ck_dir)
        target_stage = self.stages[0]
        if meta and meta.get('stage') in stage_names:
            target_stage = self.stages[stage_names.index(meta['stage'])]

        def stage_optimizer(stage, model):
            # adafactor factors over the model's JAX kernel shapes
            optimizer, _ = make_optimizer(
                stage_opt_spec(stage), stage_steps(stage),
                kernel_shapes=jax_kernel_shapes(model))
            return optimizer

        def fresh_state(stage):
            model = create_model(
                **self.model_spec, input_shape=x_train.shape[1:],
                device=device,
                generator=torch.Generator(device).manual_seed(self.seed))
            return create_train_state(model, stage_optimizer(stage, model),
                                      seed=self.seed, with_dropout_rng=True)

        state = fresh_state(target_stage)
        model = state.model
        n_params = param_count(model)
        self.info(f'model={self.model_spec.get("name")} params={n_params:,} '
                  f'device={device} device_data={use_device_data}')
        if self._telemetry is not None:
            # the run.snapshot row: the context the postmortem bundle
            # freezes next to the series
            from mlcomp_tpu_torch.telemetry import persist_run_snapshot
            try:
                persist_run_snapshot(self.session, self.task.id, {
                    'model': self.model_spec.get('name'),
                    'model_spec': {k: v for k, v in self.model_spec.items()
                                   if isinstance(v, (str, int, float,
                                                     bool))},
                    'n_params': int(n_params),
                    'mesh': {'dp': 1},
                    'devices': 1,
                    'device': str(device),
                    'batch_size': int(self.batch_size),
                    'batch_shape': [int(self.batch_size)]
                    + [int(d) for d in x_train.shape[1:]],
                    'input_dtype': str(x_train.dtype),
                    'loss': self.loss_name,
                })
            except Exception:
                pass            # context is best-effort, never fatal

        epochs_done_global = 0
        restored = None
        if meta is not None:
            try:
                restored, meta = restore_checkpoint(
                    ck_dir, self._restore_into(state, device))
            except Exception as e:  # config drift: start fresh
                self.error(f'checkpoint restore failed ({e}); '
                           f'starting from scratch')
                meta = None
                if target_stage is not self.stages[0]:
                    state = fresh_state(self.stages[0])
                    model = state.model
        if restored is None and self.params_file:
            # pretrained weights seed a fresh run only: a checkpoint
            # restore (a resume) wins over them
            from mlcomp_tpu_torch.train.pretrained import apply_pretrained
            state, summary = apply_pretrained(state, self.params_file)
            self.info(f'pretrained {self.params_file}: {summary}')
        best = None
        if restored is not None:
            epochs_done_global = int(meta.get('epoch', -1)) + 1
            # seed best-score tracking from the surviving best checkpoint
            best_meta = load_meta(ck_dir, 'best')
            if best_meta and best_meta.get('score') is not None:
                best = float(best_meta['score'])
            self.info(
                f'resumed from checkpoint: stage={meta.get("stage")} '
                f'epoch={meta.get("epoch")} best={best}')
        remaining, start_epoch = resume_plan(self.stages, meta)
        if dispatch_stage is not None:
            remaining = [s for s in remaining
                         if s['name'] == dispatch_stage] or remaining[:1]
        global_epoch = epochs_done_global
        samples_seen = 0
        for stage in remaining:
            stage_name = stage['name']
            stage_idx = stage_names.index(stage_name)
            optimizer = stage_optimizer(stage, model)
            if use_device_data:
                train_step = make_device_train_step(
                    model, optimizer, loss_fn, augment=dev_augment,
                    dequantize=dequant)
                eval_step = make_device_eval_step(model, loss_fn,
                                                  dequantize=dequant_v)
            else:
                train_step = make_train_step(model, optimizer, loss_fn,
                                             self_supervised=self_supervised)
                eval_step = make_eval_step(model, loss_fn,
                                           self_supervised=self_supervised)
            if self._telemetry is not None:
                train_step = instrumented_step(
                    train_step, self._telemetry,
                    batch_size=self.batch_size,
                    attribution=self._attribution,
                    tripwire=self._tripwire,
                    compile_events=self._compile_events,
                    memory=self._memory, deviceprof=self._deviceprof,
                    probe=self._probe)
            first_epoch = start_epoch if stage is remaining[0] else 0
            if first_epoch == 0 and stage is not self.stages[0]:
                # stage boundary: fresh optimizer state, keep params
                state.opt_state = optimizer.init(state.params)
            self.step.start(1, f'stage {stage_name}', stage_idx)
            for epoch in range(first_epoch, int(stage.get('epochs', 1))):
                self.step.start(2, f'epoch {epoch}', epoch)
                ep_rng = np.random.RandomState(self.seed * 1000 + epoch)
                profiling = self._maybe_start_profile(global_epoch, ck_dir,
                                                      device)
                t_ep = time.time()
                train_metrics = []
                first = global_epoch == epochs_done_global
                attr = self._attribution
                if use_device_data:
                    if steps_per_epoch * self.batch_size > len(x_train):
                        raise ValueError(
                            f'dataset has {len(x_train)} train samples — '
                            f'fewer than batch_size={self.batch_size}; no '
                            f'full batch to train on')
                    dropped = len(x_train) % self.batch_size
                    if dropped and first:
                        self.info(
                            f'dropping {dropped} tail samples '
                            f'(n={len(x_train)} not divisible by '
                            f'batch_size={self.batch_size})')
                    perm = ep_rng.permutation(len(x_train))[
                        :steps_per_epoch * self.batch_size]
                    # the epoch's indices: the loop's one host→device
                    # copy, attributed to the first step's h2d
                    if attr is not None:
                        attr.begin('h2d')
                    perm = place_batch((perm.reshape(
                        steps_per_epoch, self.batch_size), None), device)[0]
                    for s in range(steps_per_epoch):
                        # taking the step's index row is the data wait;
                        # the batch itself is already on the device
                        if attr is not None:
                            attr.begin('data_wait')
                        idx = perm[s]
                        if attr is not None:
                            attr.begin('h2d')
                        state, metrics = train_step(state, x_all, y_all, idx)
                        train_metrics.append(metrics)
                    samples_seen += steps_per_epoch * self.batch_size
                else:
                    batches = iterate_batches(
                        x_train, y_train, self.batch_size, ep_rng,
                        transform=transform,
                        logger=self.info if first else None)
                    for x, y in prefetch_batches(batches, device,
                                                 depth=self.prefetch,
                                                 attribution=attr):
                        state, metrics = train_step(state, x, y)
                        train_metrics.append(metrics)
                        samples_seen += self.batch_size
                if self._deviceprof is not None:
                    # a window holds train steps only
                    self._deviceprof.end_window()
                if not train_metrics:
                    raise ValueError(
                        f'dataset has {len(x_train)} train samples — '
                        f'fewer than batch_size={self.batch_size}; no '
                        f'full batch')
                # metrics: device→host once per epoch
                train_agg = aggregate_metrics(train_metrics)
                train_dt = time.time() - t_ep
                # every validation sample, in batches (one device: no
                # padding, weights all one)
                valid_metrics, valid_weights = [], []
                for start in range(0, len(x_valid), self.eval_batch_size):
                    stop = min(start + self.eval_batch_size, len(x_valid))
                    w = torch.ones(stop - start, device=device)
                    if use_device_data:
                        idx = torch.arange(start, stop, device=device)
                        valid_metrics.append(
                            eval_step(state, xv_all, yv_all, idx, w))
                    else:
                        by = y_valid[start:stop] \
                            if y_valid is not None else None
                        x, y = place_batch((x_valid[start:stop], by), device)
                        valid_metrics.append(eval_step(state, x, y, w))
                    valid_weights.append(stop - start)
                valid_agg = aggregate_metrics(valid_metrics,
                                              weights=valid_weights)
                n_train = steps_per_epoch * self.batch_size
                self.info(
                    f'[{stage_name}] epoch {global_epoch}: '
                    f'train {train_agg} valid {valid_agg} '
                    f'({n_train / train_dt:.1f} samples/s)')

                score = valid_agg.get(self.main_metric,
                                      train_agg.get(self.main_metric))
                is_best = score is not None and (
                    best is None or
                    (score < best if self.minimize else score > best))
                if is_best:
                    best = score
                    self._update_scores(score)
                for k, v in train_agg.items():
                    self._report_series(k, v, global_epoch, 'train',
                                        stage_name)
                for k, v in valid_agg.items():
                    self._report_series(k, v, global_epoch, 'valid',
                                        stage_name)
                self._report_series('images_per_sec', n_train / train_dt,
                                    global_epoch, 'train', stage_name)
                if self._telemetry is not None:
                    self._epoch_telemetry(global_epoch, stage_name, t_ep,
                                          train_dt, n_train,
                                          steps_per_epoch)
                last_of_stage = epoch == int(stage.get('epochs', 1)) - 1
                should_save = self.checkpoint_every != 0 and (
                    is_best or self.checkpoint_every <= 1
                    or (global_epoch + 1) % self.checkpoint_every == 0
                    or last_of_stage)
                if should_save:
                    meta_d = {'stage': stage_name, 'stage_epoch': epoch,
                              'epoch': global_epoch, 'score': score,
                              'step': int(state.step)}
                    # the host copy is taken now: the next step updates
                    # the parameters in place
                    host_state = self._host_tree(state)
                    if self._ckpt_writer is not None:
                        self._ckpt_writer.submit(ck_dir, host_state, meta_d,
                                                 best=is_best)
                    else:
                        save_checkpoint(ck_dir, host_state, meta_d,
                                        best=is_best)
                if profiling:
                    self._stop_profile(global_epoch)
                global_epoch += 1
                # the chaos seam (testing/faults.py): a fault armed for
                # train.epoch fires here, after the epoch's checkpoint
                # submit; one module-global check when none is armed
                fault_point('train.epoch', epoch=global_epoch,
                            task=self.task.id if self.task else None)
            if (dispatch_stage is not None or self.stage_per_dispatch) \
                    and stage_name != stage_names[-1]:
                # return for the requeue: the next dispatch runs the next
                # stage; the last stage's dispatch goes on to the export
                self._drain_ckpt_writer()
                return {'stage': stage_name, 'stages': stage_names,
                        'best_score': best}

        # everything below reads checkpoint files — drain pending writes
        self._drain_ckpt_writer()
        if self.model_name:
            self._export_model(ck_dir, best,
                               input_shape=[int(d) for d in
                                            x_train.shape[1:]],
                               input_dtype=str(x_train.dtype))
        if self.infer_valid:
            self._infer_valid(state, ck_dir, x_valid, y_valid, device)
        wall = time.time() - t_start
        return {'stage': stage_names[-1], 'stages': stage_names,
                'best_score': best, 'n_params': n_params,
                'wall_time_s': wall,
                'samples_per_sec': samples_seen / max(wall, 1e-9)}

    def _epoch_telemetry(self, global_epoch, stage_name, t_ep, train_dt,
                         n_train, steps_per_epoch):
        """The epoch's gauges (time, throughput, MFU, the card's memory,
        the pipeline efficiency), a flush, the ``train.epoch`` span and
        the on-demand trace's poll."""
        from mlcomp_tpu_torch.telemetry import (
            mfu, record_device_stats, record_span,
        )
        from mlcomp_tpu_torch.telemetry.device import DEFAULT_PEAK_TFLOPS
        tel = self._telemetry
        self._report_probe()
        tel.gauge('epoch_time_s', train_dt)
        tel.gauge('epoch_throughput', n_train / train_dt)
        if self._probe.flops:
            peak = float(self.telemetry_spec.get(
                'peak_tflops', os.environ.get('MLCOMP_PEAK_TFLOPS',
                                              DEFAULT_PEAK_TFLOPS)))
            tel.gauge('mfu', mfu(self._probe.flops,
                                 steps_per_epoch / train_dt, 1, peak))
        record_device_stats(tel)
        if self._attribution.steps:
            self._attribution.emit_epoch(tel, epoch=global_epoch)
        tel.flush()
        record_span('train.epoch', started=t_ep,
                    duration=time.time() - t_ep, task=self.task.id,
                    role='train', tags={'epoch': global_epoch,
                                        'stage': stage_name})
        self._profiler.poll()

    def _predict_valid(self, model, x_valid, device) -> np.ndarray:
        """Softmax predictions (f32) of ``model`` in eval mode over the
        validation set, in ``eval_batch_size`` batches."""
        probs = []
        with torch.inference_mode():
            for bx, _ in iterate_batches(x_valid, None, self.eval_batch_size,
                                         drop_last=False):
                x, _ = place_batch((bx, None), device)
                probs.append(torch.softmax(model(x).float(), dim=-1).cpu())
        return torch.cat(probs).numpy() if probs else np.empty((0,))

    def _infer_valid(self, state, ck_dir, x_valid, y_valid, device):
        """Save the validation set's predictions as npy for the Valid
        and ensemble stages downstream: ``data/pred/<out_prefix>.npy``
        (and ``<out_prefix>_y.npy``, the labels). ``best_only`` (the
        default) loads the best checkpoint's ``params`` and
        ``batch_stats`` into the model first, so the predictions are the
        best epoch's; the optimizer state is not read (the port's layout,
        ``train/checkpoint.py``). A best checkpoint that does not load is
        logged, and the final state predicts."""
        from mlcomp_tpu_torch.worker.executors.base.equation import (
            PRED_FOLDER,
        )
        spec = self.infer_valid
        prefix = spec.get('out_prefix') or self.model_name or 'valid'
        model = state.model
        if bool(spec.get('best_only', True)):
            def load_weights(tree):
                model.load_state_dict(self._fitting_state_dict(tree, model))
                return model
            try:
                restore_checkpoint(ck_dir, load_weights, kind='best')
            except Exception as e:  # a best saved by another model
                self.info(f'infer_valid: best checkpoint not loadable '
                          f'({e}); using final state')
        probs = self._predict_valid(model, x_valid, device)
        os.makedirs(PRED_FOLDER, exist_ok=True)
        out = os.path.join(PRED_FOLDER, f'{prefix}.npy')
        np.save(out, probs)
        if y_valid is not None:
            np.save(os.path.join(PRED_FOLDER, f'{prefix}_y.npy'),
                    np.asarray(y_valid))
        self.info(f'infer_valid: {len(probs)} predictions -> {out}')

    def _export_model(self, ck_dir, best_score, input_shape=None,
                      input_dtype=None):
        """Write the deployable export for the model registry from the
        best checkpoint (else the last), with the input shape and dtype
        the serving process warms up with."""
        from mlcomp_tpu_torch.train.export import export_from_checkpoint
        src = checkpoint_exists(ck_dir, 'best') \
            or checkpoint_exists(ck_dir, 'last')
        if not src:
            return
        out = os.path.join(self._model_folder(), self.model_name)
        meta = {'score': best_score}
        if input_shape:
            meta['input_shape'] = list(input_shape)
        if input_dtype:
            meta['input_dtype'] = str(input_dtype)
        export_from_checkpoint(src, self.model_spec, out, meta=meta)
        self.info(f'exported model {self.model_name!r} -> {out}.msgpack')


__all__ = ['Train']
