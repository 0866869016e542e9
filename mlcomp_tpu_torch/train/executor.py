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
pipeline (pinned batches copied ahead of the step) or, with
``device_data`` (``auto``, the default, or ``true``), over a dataset
resident on the device with on-device ``augment`` (``device_data.py``;
the JAX trainer's selection rule), ``main_metric`` / ``minimize`` best
tracking, ``checkpoint_every``, the async checkpoint writer, resume
through ``resume_plan``, running statistics (``batch_stats``) in
checkpoints and the export, and the ``model_name`` export. ``mesh`` may
be ``{dp: 1}`` or ``{dp: -1}`` ("every device") on one device. Keys
whose feature is not ported yet raise ``NotImplementedError`` with
their ROADMAP.md item; unknown keys are logged as the JAX trainer logs
them.
"""

import os
import time

import numpy as np
import torch

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
from mlcomp_tpu_torch.train.loop import (
    aggregate_metrics, create_train_state, loss_for_task,
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
    'epoch_scan': 'A2 (one dispatch per epoch)',
    'profile': 'A6 (device traces)',
    'infer_valid': 'A5 (validation predictions for Valid/ensembles)',
    'report_imgs': 'slice 4 (report images need the DB)',
    'stage_per_dispatch': 'slice 4 (requeue needs the DB)',
    'params_file': 'A5 (pretrained.py head-swap)',
    'telemetry': 'A6 (device telemetry)',
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
        if self.model_spec.get('params_file'):
            _not_ported('params_file')
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
        for key, value in (('epoch_scan', epoch_scan), ('profile', profile),
                           ('infer_valid', infer_valid),
                           ('report_imgs', report_imgs),
                           ('stage_per_dispatch', stage_per_dispatch),
                           ('telemetry', isinstance(telemetry, dict))):
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
        if self.checkpoint_every == 0 and model_name:
            raise ValueError(
                'checkpoint_every: 0 disables saving, but model_name '
                'export reads checkpoint files — drop one')
        self.async_checkpoint = bool(async_checkpoint)
        self.device = device
        # leftover config keys: logged loudly by _work, not an error
        self._unknown_kwargs = sorted(kwargs)

    # ------------------------------------------------------------ plumbing
    def _checkpoint_folder(self):
        if self.checkpoint_dir:
            return self.checkpoint_dir
        from mlcomp_tpu_torch import TASK_FOLDER
        task_id = getattr(self.task, 'id', 0) if self.task else 0
        return os.path.join(TASK_FOLDER, str(task_id), 'checkpoints')

    def _model_folder(self):
        return 'models'

    def _host_tree(self, state) -> dict:
        """A host copy of the train state in the checkpoint layout:
        ``params`` (and ``batch_stats``, where the model keeps running
        statistics) in the JAX layout, ``opt_state`` in the port's."""
        return {'step': int(state.step),
                **variables_to_jax(state.model),
                'opt_state': state_to_host(state.opt_state),
                'rng': state.rng}

    def _restore_into(self, state, device):
        """``restore_checkpoint``'s target: check that a checkpoint tree
        fits ``state`` (raise if not), then load it in place."""
        def target(tree):
            sd = state_dict_from_jax(tree, self.model_spec['name'])
            current = state.model.state_dict()
            if sd.keys() != current.keys() or any(
                    sd[k].shape != current[k].shape for k in sd):
                raise ValueError('checkpoint params do not fit the model')
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
        ok = False
        try:
            result = self._work()
            ok = True
            return result
        finally:
            writer, self._ckpt_writer = self._ckpt_writer, None
            if writer is not None:
                try:
                    writer.close()
                except Exception as e:
                    self.error(f'checkpoint writer: {e}')
                    if ok:
                        raise

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
        if self.augment and not use_device_data:
            raise NotImplementedError(
                f'train: augment {self.augment!r} needs the host pipeline\'s '
                f'transforms, which are not ported yet (ROADMAP.md, queue A: '
                f'A7); the device-resident path runs {DEVICE_AUGMENTS}')
        if use_device_data:
            x_q, dequant = quantize_dataset(x_train)
            x_all, y_all = place_dataset(x_q, y_train, device)
            xv_q, dequant_v = quantize_dataset(x_valid)
            xv_all, yv_all = place_dataset(xv_q, y_valid, device)
            dev_augment = make_device_augment(
                device_augs, x_train.shape[1:]) if device_augs else None

        ck_dir = self._checkpoint_folder()
        steps_per_epoch = max(1, len(x_train) // self.batch_size)

        def stage_opt_spec(stage):
            return stage.get('optimizer') or \
                self.stages[0].get('optimizer')

        def stage_steps(stage):
            return int(stage.get('epochs', 1)) * steps_per_epoch

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
            first_epoch = start_epoch if stage is remaining[0] else 0
            if first_epoch == 0 and stage is not self.stages[0]:
                # stage boundary: fresh optimizer state, keep params
                state.opt_state = optimizer.init(state.params)
            self.step.start(1, f'stage {stage_name}', stage_idx)
            for epoch in range(first_epoch, int(stage.get('epochs', 1))):
                self.step.start(2, f'epoch {epoch}', epoch)
                ep_rng = np.random.RandomState(self.seed * 1000 + epoch)
                t_ep = time.time()
                train_metrics = []
                first = global_epoch == epochs_done_global
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
                    # the epoch's indices: the loop's one host→device copy
                    perm = place_batch((perm.reshape(
                        steps_per_epoch, self.batch_size), None), device)[0]
                    for idx in perm:
                        state, metrics = train_step(state, x_all, y_all, idx)
                        train_metrics.append(metrics)
                    samples_seen += steps_per_epoch * self.batch_size
                else:
                    batches = iterate_batches(
                        x_train, y_train, self.batch_size, ep_rng,
                        logger=self.info if first else None)
                    for x, y in prefetch_batches(batches, device,
                                                 depth=self.prefetch):
                        state, metrics = train_step(state, x, y)
                        train_metrics.append(metrics)
                        samples_seen += self.batch_size
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
                global_epoch += 1

        # everything below reads checkpoint files — drain pending writes
        self._drain_ckpt_writer()
        if self.model_name:
            self._export_model(ck_dir, best,
                               input_shape=[int(d) for d in
                                            x_train.shape[1:]],
                               input_dtype=str(x_train.dtype))
        wall = time.time() - t_start
        return {'stage': stage_names[-1], 'stages': stage_names,
                'best_score': best, 'n_params': n_params,
                'wall_time_s': wall,
                'samples_per_sec': samples_seen / max(wall, 1e-9)}

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
