"""Optimizer and learning-rate schedule factory — port of
``mlcomp_tpu/train/optim.py``, with optax's semantics written out.

An optimizer here is what optax calls a ``GradientTransformation``:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, over dicts of tensors keyed by parameter name (a model's
``named_parameters()``); ``apply_updates`` adds the updates in place.
States are nested dicts of tensors and ints, so a checkpoint can store
them as they are (``state_to_host`` / ``state_to_device``).

The same spec keys and the same ``ValueError``s as the JAX package::

    optimizer:
      name: adamw            # sgd | adam | adamw | lamb | adafactor
      lr: 0.001
      weight_decay: 0.01
      grad_clip: 1.0
      accum_steps: 4
      master_dtype: bfloat16
      schedule:
        name: warmup_cosine  # constant | cosine | warmup_cosine |
        warmup_steps: 100    #   onecycle | step
        decay_steps: 10000

optax's semantics, kept exactly: adam's eps outside the square root and
bias correction by ``1 - b**count`` (in f32) at the incremented count;
adamw's decoupled weight decay added to the adam direction and scaled by
the scheduled lr; the schedule read at the count before it increments;
``grad_clip`` by the global norm, untouched below it; ``accum_steps`` as
``optax.MultiSteps`` (running mean of k micro-gradients, zero updates
between, schedule counts in microbatch steps converted to updates);
``master_dtype`` as ``master_weight_update`` (f32 update arithmetic for
low-precision masters). Schedules are evaluated in f32, as jnp does.

``lamb`` is ``optax.lamb(sched, weight_decay=wd)``: adam (eps 1e-6),
the decayed weights added, each update scaled by its trust ratio
``|p| / |u|`` (1 where either norm is 0), then by the scheduled lr.
``adafactor`` is ``optax.adafactor(sched)`` with optax's defaults:
``scale_by_factored_rms`` (second moments factored into a row and a
column vector over the two largest dims of a leaf when the smaller of
them is ≥ 128, else kept whole; decay ``1 - (count+1)^-0.8``, epsilon
1e-30), the update clipped to block rms 1, times the scheduled lr, times
the parameter's rms (at least 1e-3), negated. Its state is optax's
``FactoredState`` as a dict: ``{'count', 'v_row', 'v_col', 'v'}``, each
tree keyed by parameter name, a (1,)-shaped zero where a leaf does not
use it. Where the JAX kernel shape of a parameter is given
(``kernel_shapes``, from ``convert.jax_kernel_shapes``: the
transformer's projections, whose JAX kernel is
``weight.t().reshape(shape)``), adafactor factors over that shape and
keeps its state in it, as optax does over the JAX tree: a fused ``qkv``
[M, 3, H, D] whose two largest dims are M and D factors only when
D ≥ 128.
"""

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch


class GradientTransformation(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[..., tuple]


def _f32(x) -> np.float32:
    return np.float32(x)


# --------------------------------------------------------------- schedules
def constant_schedule(value):
    return lambda count: _f32(value)


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    if not decay_steps > 0:
        raise ValueError(
            'The cosine_decay_schedule requires positive decay_steps, got'
            f' decay_steps={decay_steps}.')

    def schedule(count):
        count = min(_f32(count), _f32(decay_steps))
        cos = _f32(0.5) * (_f32(1) + _f32(np.cos(
            _f32(np.pi) * count / _f32(decay_steps))))
        return _f32(init_value) * ((_f32(1) - _f32(alpha)) * cos
                                   + _f32(alpha))
    return schedule


def linear_schedule(init_value, end_value, transition_steps):
    if transition_steps <= 0:
        return lambda count: _f32(init_value)

    def schedule(count):
        count = _f32(min(max(count, 0), transition_steps))
        frac = _f32(1) - count / _f32(transition_steps)
        return (_f32(init_value) - _f32(end_value)) * frac + _f32(end_value)
    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0):
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha)
    return lambda count: warm(count) if count < warmup_steps \
        else cosine(count - warmup_steps)


def piecewise_constant_schedule(init_value, boundaries_and_scales=None):
    if boundaries_and_scales is not None and not all(
            s >= 0.0 for s in boundaries_and_scales.values()):
        raise ValueError(
            '`piecewise_constant_schedule` expects non-negative scale '
            'factors')

    def schedule(count):
        v = _f32(init_value)
        for threshold, scale in sorted((boundaries_and_scales or {}).items()):
            if count >= threshold:
                v = v * _f32(scale)
        return v
    return schedule


# ---------------------------------------------------------- transformations
def _names(tree: dict) -> list:
    return list(tree)


def _zeros_like(params: dict, dtype=None) -> dict:
    return {n: torch.zeros_like(p, dtype=dtype) for n, p in params.items()}


def _scale_all(updates: dict, factor) -> dict:
    """Every update times the scalar ``factor`` rounded to the update's
    dtype first (optax's ``jnp.array(step_size, dtype=g.dtype) * g``)."""
    by_dtype = {}
    for n, u in updates.items():
        by_dtype.setdefault(u.dtype, []).append(n)
    out = {}
    for dtype, names in by_dtype.items():
        f = torch.tensor(float(factor), dtype=dtype).item()
        out.update(zip(names, torch._foreach_mul(
            [updates[n] for n in names], f)))
    return {n: out[n] for n in updates}


def scale_by_schedule(schedule) -> GradientTransformation:
    def init(params):
        return {'count': 0}

    def update(updates, state, params=None):
        step_size = schedule(state['count'])
        return _scale_all(updates, step_size), {'count': state['count'] + 1}
    return GradientTransformation(init, update)


def scale_by_learning_rate(schedule) -> GradientTransformation:
    return scale_by_schedule(lambda count: -schedule(count))


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    def init(params):
        return {'count': 0, 'mu': _zeros_like(params),
                'nu': _zeros_like(params)}

    def update(updates, state, params=None):
        names = _names(updates)
        g = [updates[n] for n in names]
        mu = [state['mu'][n] for n in names]
        nu = [state['nu'][n] for n in names]
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu, in place
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - b2))
        count = state['count'] + 1
        c1 = float(_f32(1) - _f32(b1) ** _f32(count))
        c2 = float(_f32(1) - _f32(b2) ** _f32(count))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(denom, eps)
        out = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        return dict(zip(names, out)), {'count': count, 'mu': state['mu'],
                                       'nu': state['nu']}
    return GradientTransformation(init, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def init(params):
        return {'trace': _zeros_like(params)}

    def update(updates, state, params=None):
        names = _names(updates)
        g = [updates[n] for n in names]
        t = [state['trace'][n] for n in names]
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, g)          # new trace = g + decay * trace
        out = torch._foreach_add(g, torch._foreach_mul(t, decay)) \
            if nesterov else [x.clone() for x in t]
        return dict(zip(names, out)), state
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def init(params):
        return {}

    def update(updates, state, params=None):
        if params is None:
            raise ValueError('add_decayed_weights needs params')
        return {n: u + weight_decay * params[n].detach()
                for n, u in updates.items()}, state
    return GradientTransformation(init, update)


def scale(step_size: float) -> GradientTransformation:
    def init(params):
        return {}

    def update(updates, state, params=None):
        return _scale_all(updates, step_size), state
    return GradientTransformation(init, update)


def scale_by_trust_ratio() -> GradientTransformation:
    """optax's ``scale_by_trust_ratio()``: each update times
    ``|p| / |u|`` (L2 over the whole leaf), 1 where either is 0."""
    def init(params):
        return {}

    def update(updates, state, params=None):
        if params is None:
            raise ValueError('scale_by_trust_ratio needs params')
        out = {}
        for n, u in updates.items():
            p_norm = torch.linalg.vector_norm(params[n].detach())
            u_norm = torch.linalg.vector_norm(u)
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            out[n] = u * ratio.to(u.dtype)
        return out, state
    return GradientTransformation(init, update)


def _decay_rate_pow(count: int, exponent: float = 0.8) -> np.float32:
    """Adafactor's second-moment decay at step ``count``, in f32."""
    t = _f32(count + 1)
    return _f32(1) - t ** _f32(-exponent)


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    """(d1, d0): the second largest and the largest dim of ``shape``, or
    None where the leaf is kept whole (optax's rule)."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def scale_by_factored_rms(decay_rate: float = 0.8,
                          min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30,
                          kernel_shapes: Optional[dict] = None
                          ) -> GradientTransformation:
    """optax's ``scale_by_factored_rms`` (module docstring); a leaf named
    in ``kernel_shapes`` is read as ``t.t().reshape(shape)``."""
    shapes = dict(kernel_shapes or {})

    def view(name, t):
        return t.t().reshape(shapes[name]) if name in shapes else t

    def unview(name, t, like):
        if name not in shapes:
            return t
        return t.reshape(like.shape[1], like.shape[0]).t()

    def init(params):
        state = {'count': 0, 'v_row': {}, 'v_col': {}, 'v': {}}
        for n, p in params.items():
            shape, dtype = tuple(view(n, p.detach()).shape), p.dtype
            one = torch.zeros((1,), dtype=dtype, device=p.device)
            dims = _factored_dims(shape, min_dim_size_to_factor)
            if dims is not None:
                d1, d0 = dims
                state['v_row'][n] = torch.zeros(
                    tuple(np.delete(shape, d0)), dtype=dtype, device=p.device)
                state['v_col'][n] = torch.zeros(
                    tuple(np.delete(shape, d1)), dtype=dtype, device=p.device)
                state['v'][n] = one
            else:
                state['v_row'][n] = one
                state['v_col'][n] = one.clone()
                state['v'][n] = torch.zeros(shape, dtype=dtype,
                                            device=p.device)
        return state

    def update(updates, state, params=None):
        if params is None:
            raise ValueError('scale_by_factored_rms needs params')
        decay = _decay_rate_pow(state['count'], decay_rate)
        keep, new = float(decay), float(_f32(1) - decay)
        out, v_row, v_col, v = {}, {}, {}, {}
        for n, u in updates.items():
            g = view(n, u)
            dtype = params[n].dtype
            dims = _factored_dims(tuple(g.shape), min_dim_size_to_factor)
            g_sqr = g * g + epsilon
            if dims is not None:
                d1, d0 = dims
                v_row[n] = (keep * state['v_row'][n]
                            + new * g_sqr.mean(dim=d0)).to(dtype)
                v_col[n] = (keep * state['v_col'][n]
                            + new * g_sqr.mean(dim=d1)).to(dtype)
                v[n] = state['v'][n]
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row[n].mean(dim=reduced_d1, keepdim=True)
                row_factor = (v_row[n] / row_col_mean) ** -0.5
                col_factor = v_col[n] ** -0.5
                step = (g * row_factor.unsqueeze(d0)
                        * col_factor.unsqueeze(d1))
            else:
                v_row[n], v_col[n] = state['v_row'][n], state['v_col'][n]
                v[n] = (keep * state['v'][n] + new * g_sqr).to(dtype)
                step = g * v[n] ** -0.5
            out[n] = unview(n, step, u)
        return out, {'count': state['count'] + 1, 'v_row': v_row,
                     'v_col': v_col, 'v': v}
    return GradientTransformation(init, update)


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    """optax's ``clip_by_block_rms``: each leaf divided by
    ``max(1, rms(u) / threshold)``."""
    def init(params):
        return {}

    def update(updates, state, params=None):
        return {n: u / torch.clamp_min(u.square().mean().sqrt() / threshold,
                                       1.0)
                for n, u in updates.items()}, state
    return GradientTransformation(init, update)


def scale_by_param_block_rms(min_scale: float = 1e-3
                             ) -> GradientTransformation:
    """optax's ``scale_by_param_block_rms``: each leaf times the rms of
    its parameter, at least ``min_scale``."""
    def init(params):
        return {}

    def update(updates, state, params=None):
        if params is None:
            raise ValueError('scale_by_param_block_rms needs params')
        out = {}
        for n, u in updates.items():
            rms = params[n].detach().square().mean().sqrt()
            out[n] = u * torch.clamp_min(rms, min_scale).to(u.dtype)
        return out, state
    return GradientTransformation(init, update)


def lamb(schedule, weight_decay: float = 0.0) -> GradientTransformation:
    """``optax.lamb(schedule, weight_decay=weight_decay)``."""
    return chain(scale_by_adam(0.9, 0.999, eps=1e-6),
                 add_decayed_weights(weight_decay),
                 scale_by_trust_ratio(),
                 scale_by_learning_rate(schedule))


def adafactor(schedule, kernel_shapes: Optional[dict] = None
              ) -> GradientTransformation:
    """``optax.adafactor(schedule)`` with optax's defaults (module
    docstring)."""
    return chain(scale_by_factored_rms(kernel_shapes=kernel_shapes),
                 clip_by_block_rms(1.0),
                 scale_by_schedule(schedule),
                 scale_by_param_block_rms(1e-3),
                 scale(-1.0))


def global_norm(updates: dict) -> torch.Tensor:
    return torch.sqrt(sum(u.float().square().sum()
                          for u in updates.values()))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return {}

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        # below the bound the updates pass untouched; above it each is
        # (t / norm) * max_norm
        trigger = g_norm < max_norm
        return {n: torch.where(trigger, u, (u / g_norm.to(u.dtype))
                               * max_norm)
                for n, u in updates.items()}, state
    return GradientTransformation(init, update)


def chain(*transforms) -> GradientTransformation:
    def init(params):
        return {str(i): t.init(params) for i, t in enumerate(transforms)}

    def update(updates, state, params=None):
        new_state = {}
        for i, t in enumerate(transforms):
            updates, new_state[str(i)] = t.update(updates, state[str(i)],
                                                  params)
        return updates, new_state
    return GradientTransformation(init, update)


def multi_steps(inner: GradientTransformation,
                every_k: int) -> GradientTransformation:
    """``optax.MultiSteps(inner, every_k_schedule=every_k)``: a running
    mean of the micro-gradients; every k-th call hands it to ``inner``
    and emits its updates, the calls between emit zeros (``None`` here:
    nothing to apply) and leave ``inner``'s state as it was."""
    def init(params):
        return {'mini_step': 0, 'gradient_step': 0,
                'inner': inner.init(params), 'acc_grads': _zeros_like(params)}

    def update(updates, state, params=None):
        n = state['mini_step']
        names = _names(updates)
        acc = [state['acc_grads'][x] for x in names]
        grads = [updates[x] for x in names]
        # Welford mean: acc + (g - acc) / (n + 1)
        torch._foreach_add_(acc, torch._foreach_div(
            torch._foreach_sub(grads, acc), n + 1))
        if n < every_k - 1:
            return None, dict(state, mini_step=n + 1)
        out, inner_state = inner.update(
            dict(zip(names, acc)), state['inner'], params)
        for a in acc:
            a.zero_()
        return out, {'mini_step': 0,
                     'gradient_step': state['gradient_step'] + 1,
                     'inner': inner_state, 'acc_grads': state['acc_grads']}
    return GradientTransformation(init, update)


def master_weight_update(inner: GradientTransformation,
                         master_dtype: str) -> GradientTransformation:
    """Low-precision master weights, f32 update arithmetic: grads and
    params are upcast to f32 at the boundary (the state ``inner``
    allocates from them is therefore f32) and the updates are cast back
    to each param's own dtype. A no-op for float32."""
    from mlcomp_tpu_torch.models.transformer import torch_dtype
    if torch_dtype(master_dtype) == torch.float32:
        return inner

    def up(tree):
        return {n: t.float() if t.is_floating_point() else t
                for n, t in tree.items()}

    def init(params):
        return inner.init(up(params))

    def update(updates, state, params=None):
        out, state = inner.update(
            up(updates), state, up(params) if params is not None else None)
        if out is not None and params is not None:
            out = {n: u.to(params[n].dtype)
                   if params[n].is_floating_point() else u
                   for n, u in out.items()}
        return out, state
    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params: dict, updates: Optional[dict]):
    """``p += u`` in place for each parameter (nothing when ``updates``
    is None: an accumulation step)."""
    if updates is None:
        return
    names = _names(updates)
    torch._foreach_add_([params[n] for n in names],
                        [updates[n].to(params[n].dtype) for n in names])


# ----------------------------------------------------------------- factory
# Unknown spec keys are config errors, not no-ops (as in the JAX package)
_COMMON_KEYS = {'name', 'lr', 'weight_decay', 'grad_clip',
                'accum_steps', 'schedule', 'master_dtype'}
_OPT_KEYS = {
    'sgd': {'momentum', 'nesterov'},
    'adam': {'b1', 'b2'},
    'adamw': {'b1', 'b2'},
    'lamb': set(),
    'adafactor': set(),
}
_SCHED_KEYS = {
    'constant': {'name'},
    'cosine': {'name', 'decay_steps', 'final_lr'},
    'warmup_cosine': {'name', 'decay_steps', 'warmup_steps',
                      'final_lr', 'init_lr'},
    'onecycle': {'name', 'decay_steps', 'warmup_steps',
                 'final_lr', 'init_lr'},
    'step': {'name', 'decay_steps', 'boundaries', 'gammas'},
}


def make_schedule(lr: float, spec: Optional[dict],
                  total_steps: Optional[int] = None):
    spec = dict(spec or {'name': 'constant'})
    name = spec.get('name', 'constant').lower()
    if name in _SCHED_KEYS:
        unknown = set(spec) - _SCHED_KEYS[name]
        if unknown:
            raise ValueError(
                f'unknown schedule key(s) {sorted(unknown)} for '
                f'{name!r}; valid: {sorted(_SCHED_KEYS[name])}')
    decay_steps = int(spec.get('decay_steps') or total_steps or 10000)
    warmup = int(spec.get('warmup_steps', 0))
    final = float(spec.get('final_lr', 0.0))
    if name == 'constant':
        return constant_schedule(lr)
    if name == 'cosine':
        return cosine_decay_schedule(lr, decay_steps,
                                     alpha=final / lr if lr else 0)
    if name in ('warmup_cosine', 'onecycle'):
        warmup = warmup or max(1, decay_steps // 25)
        # a warmup longer than the whole run degrades to fit it
        warmup = min(warmup, max(decay_steps - 1, 0))
        return warmup_cosine_decay_schedule(
            init_value=float(spec.get('init_lr', lr / 25)),
            peak_value=lr, warmup_steps=warmup,
            decay_steps=decay_steps, end_value=final)
    if name == 'step':
        boundaries = {
            int(b): float(g) for b, g in
            zip(spec.get('boundaries', []), spec.get('gammas', []))
        } or {decay_steps // 2: 0.1}
        return piecewise_constant_schedule(lr, boundaries)
    raise ValueError(f'unknown schedule {name!r}')


def make_optimizer(spec: Optional[dict],
                   total_steps: Optional[int] = None,
                   kernel_shapes: Optional[dict] = None):
    """``(GradientTransformation, schedule)`` from an optimizer spec.
    ``kernel_shapes`` (``convert.jax_kernel_shapes(model)``) is read by
    ``adafactor`` alone (module docstring)."""
    spec = dict(spec or {})
    name = spec.get('name', 'adam').lower()
    if name in _OPT_KEYS:
        unknown = set(spec) - _COMMON_KEYS - _OPT_KEYS[name]
        if unknown:
            raise ValueError(
                f'unknown optimizer key(s) {sorted(unknown)} for '
                f'{name!r}; valid: '
                f'{sorted(_COMMON_KEYS | _OPT_KEYS[name])}')
    lr = float(spec.get('lr', 1e-3))
    wd = float(spec.get('weight_decay', 0.0))
    accum = int(spec.get('accum_steps', 1))
    if accum < 1:
        raise ValueError(f'accum_steps must be >= 1, got {accum}')
    if accum > 1 and total_steps:
        if total_steps < accum:
            raise ValueError(
                f'accum_steps={accum} exceeds the stage\'s '
                f'{total_steps} total steps — no optimizer update '
                f'would ever fire; lower accum_steps or raise '
                f'epochs/dataset size')
        total_steps = max(1, total_steps // accum)
    sched_spec = spec.get('schedule')
    if accum > 1 and sched_spec:
        # schedule counts are written in microbatch steps; the inner
        # optimizer counts updates
        sched_spec = dict(sched_spec)
        for key in ('decay_steps', 'warmup_steps'):
            if sched_spec.get(key):
                sched_spec[key] = max(1, int(sched_spec[key]) // accum)
        if sched_spec.get('boundaries'):
            sched_spec['boundaries'] = [
                max(1, int(b) // accum) for b in sched_spec['boundaries']]
    sched = make_schedule(lr, sched_spec, total_steps)

    if name == 'sgd':
        opt = chain(trace(float(spec.get('momentum', 0.9)),
                          nesterov=bool(spec.get('nesterov', False))),
                    scale_by_learning_rate(sched))
        if wd:
            opt = chain(add_decayed_weights(wd), opt)
    elif name == 'adam':
        opt = chain(scale_by_adam(float(spec.get('b1', 0.9)),
                                  float(spec.get('b2', 0.999))),
                    scale_by_learning_rate(sched))
        if wd:
            opt = chain(add_decayed_weights(wd), opt)
    elif name == 'adamw':
        opt = chain(scale_by_adam(float(spec.get('b1', 0.9)),
                                  float(spec.get('b2', 0.999))),
                    add_decayed_weights(float(spec.get('weight_decay',
                                                       1e-2))),
                    scale_by_learning_rate(sched))
    elif name == 'lamb':
        opt = lamb(sched, weight_decay=wd)
    elif name == 'adafactor':
        opt = adafactor(sched, kernel_shapes=kernel_shapes)
    else:
        raise ValueError(f'unknown optimizer {name!r}')

    clip = float(spec.get('grad_clip', 0.0))
    if clip:
        opt = chain(clip_by_global_norm(clip), opt)
    if accum > 1:
        opt = multi_steps(opt, accum)
    master = spec.get('master_dtype')
    if master:
        # outermost: the upcast comes before accumulation and the clip
        opt = master_weight_update(opt, str(master))
    return opt, sched


# ----------------------------------------------------------- state moving
def state_to_host(tree):
    """A copy of an optimizer state (or any nested dict of tensors and
    ints) with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: state_to_host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().to('cpu', copy=True)
    return tree


def state_to_device(tree, device):
    """``tree`` (tensors, numpy arrays and ints, as a checkpoint restores
    it) with every array as a tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: state_to_device(v, device) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        if tree.ndim == 0 and np.issubdtype(tree.dtype, np.integer):
            return int(tree)
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, np.generic):
        return tree.item()
    return tree


__all__ = ['GradientTransformation', 'make_optimizer', 'make_schedule',
           'master_weight_update', 'lamb', 'adafactor', 'apply_updates', 'global_norm',
           'state_to_host', 'state_to_device']
