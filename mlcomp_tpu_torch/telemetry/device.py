"""Device stats from inside the training process (port of
``mlcomp_tpu/telemetry/device.py``): the card's memory occupancy, a
step's FLOPs and the MFU they give.

The memory reads never initialise CUDA: with CUDA not yet running in
this process they return nothing, as the JAX module does without a live
client.

The FLOPs of a step come from running it under ``FlopCounter``, a
dispatch mode that counts as ``torch.utils.flop_counter.FlopCounterMode``
does (the counterpart of XLA's ``cost_analysis``), from torch's table of
FLOP formulas, with two differences:

- ``torch._int_mm`` (the int8 train matmul's product) gets the formula
  the table lacks;
- it does not import ``torch._dynamo``. ``TorchDispatchMode`` wraps a
  subclass's ``__torch_dispatch__`` in a lazy ``torch._dynamo`` import,
  and that import made every training process's first counted step on
  the card seconds long.

The hand kernels launch through ``ctypes``, where no dispatch mode looks.
Each one that does a product is a ``torch.library`` op with its own entry
in the table (``ops/flash_attention.py``), so this counter and
``FlopCounterMode`` both count it where it launches. The norm and
cross-entropy kernels have none, as the table counts no norm or softmax.
On the CPU the plain versions run as aten ops and are counted as such.
"""

import functools
import time

#: bf16 dense peak of one H100 SXM, TFLOP/s (NVIDIA's data sheet): the
#: MFU's default denominator; ``peak_tflops`` in the telemetry spec or
#: ``MLCOMP_PEAK_TFLOPS`` overrides it
DEFAULT_PEAK_TFLOPS = 989.0


def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
    m, k = a_shape
    _, n = b_shape
    return 2 * m * n * k


def _count_dispatch(mode, func, types, args=(), kwargs=None):
    """``FlopCounterMode``'s dispatch: an op first tries its
    decomposition (counted op by op; ``func`` is an overload, which the
    table, keyed by overload packet, never holds), then runs and adds
    its formula's count to ``mode.total``."""
    import torch
    kwargs = kwargs or {}
    if func not in mode.formulas \
            and func is not torch.ops.prim.device.default:
        with mode:
            out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
    out = func(*args, **kwargs)
    formula = mode.formulas.get(func._overloadpacket)
    if formula is not None:
        mode.total += int(formula(*args, **kwargs, out_val=out))
    return out


@functools.lru_cache(maxsize=None)
def _flop_mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class FlopMode(TorchDispatchMode):
        pass

    # set after the class exists: ``__init_subclass__`` would wrap it in
    # the lazy ``torch._dynamo`` import
    FlopMode.__torch_dispatch__ = _count_dispatch
    return FlopMode


class FlopCounter:
    """``with FlopCounter() as c: step()`` then ``c.total``: the FLOPs of
    every op with a formula in torch's table (the hand kernels'
    included) that ran inside, on any thread autograd runs the step on.
    The table is read at entry."""

    def __init__(self):
        self.mode = None

    def __enter__(self):
        import torch
        from torch.utils.flop_counter import flop_registry, shape_wrapper
        self.mode = _flop_mode_class()()
        self.mode.total = 0
        self.mode.formulas = {torch.ops.aten._int_mm:
                              shape_wrapper(_int_mm_flop), **flop_registry}
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    @property
    def total(self) -> int:
        return self.mode.total


@functools.lru_cache(maxsize=None)
def _total_memory(index: int) -> int:
    import torch
    return int(torch.cuda.get_device_properties(index).total_memory)


def cuda_memory(index: int) -> tuple:
    """(allocated, peak allocated) bytes of the caching allocator on
    card ``index``: one allocator read, no device sync."""
    import torch
    stats = torch.cuda.memory_stats_as_nested_dict(index)
    allocated = stats.get('allocated_bytes', {}).get('all', {})
    return int(allocated.get('current', 0)), int(allocated.get('peak', 0))


def device_memory_stats() -> list:
    """Per-card memory stats: ``[{'id', 'platform', 'kind',
    'bytes_in_use', 'bytes_limit', 'peak_bytes_in_use',
    'reports_memory'}]`` (the JAX module's keys). ``bytes_in_use`` is
    the caching allocator's allocated bytes, ``peak_bytes_in_use`` its
    high-water mark, ``bytes_limit`` the card's memory (read once).
    Empty while CUDA is not running in this process."""
    try:
        import torch
        if not torch.cuda.is_initialized():
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            used, peak = cuda_memory(i)
            out.append({
                'id': i, 'platform': 'gpu',
                'kind': torch.cuda.get_device_name(i),
                'bytes_in_use': used, 'bytes_limit': _total_memory(i),
                'peak_bytes_in_use': peak, 'reports_memory': True})
        return out
    except Exception:
        return []


class FirstStepProbe:
    """The first instrumented step, measured as it trains (the
    counterpart of the JAX trainer's one AOT lowering for
    ``cost_analysis`` and ``memory_analysis``): with ``flops`` the step
    runs under a ``FlopCounter`` (``self.flops``); with ``memory`` its
    bytes become ``self.attribution`` (``memory.memory_attribution``:
    the state and the batch, and on the card the step's peak allocation
    above its start, the peak reset just before). The step mutates the
    state, so counting a copy would cost a second step. No device
    sync: the caching allocator's counts are the host's."""

    def __init__(self, flops: bool = True, memory: bool = True,
                 device=None):
        self.want_flops = bool(flops)
        self.want_memory = bool(memory)
        self.device = device
        self.done = not (self.want_flops or self.want_memory)
        self.flops = None
        self.attribution = None
        #: the host's time of the measured step call (no sync)
        self.seconds = None

    def run(self, step_fn, state, *args):
        import contextlib
        self.done = True
        index = None
        if self.want_memory and getattr(self.device, 'type', None) == 'cuda':
            import torch
            index = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            torch.cuda.reset_peak_memory_stats(index)
            start = cuda_memory(index)[0]
        counter = FlopCounter() if self.want_flops else None
        t0 = time.perf_counter()
        with counter if counter is not None else contextlib.nullcontext():
            out = step_fn(state, *args)
        self.seconds = time.perf_counter() - t0
        if counter is not None:
            self.flops = counter.total
        if self.want_memory:
            from mlcomp_tpu_torch.telemetry.memory import (
                memory_attribution, tensor_bytes,
            )
            temp = cuda_memory(index)[1] - start if index is not None \
                else None
            self.attribution = memory_attribution(
                tensor_bytes(state.model, state.opt_state, args), temp)
        return out


def mfu(flops_per_step: float, steps_per_sec: float, n_devices: int,
        peak_tflops: float) -> float:
    """Model FLOPs utilization against the card's peak."""
    return (flops_per_step * steps_per_sec /
            (peak_tflops * 1e12 * max(1, n_devices)))


def record_device_stats(recorder, step: int = None):
    """Gauge rows per card: ``device<i>.hbm_used`` /
    ``device<i>.hbm_limit`` (+ ``hbm_peak`` when the allocator has a
    high-water mark). A CPU run emits nothing."""
    for d in device_memory_stats():
        if not d['reports_memory']:
            continue
        recorder.gauge(f'device{d["id"]}.hbm_used',
                       d['bytes_in_use'], step=step)
        recorder.gauge(f'device{d["id"]}.hbm_limit',
                       d['bytes_limit'], step=step)
        if d['peak_bytes_in_use']:
            recorder.gauge(f'device{d["id"]}.hbm_peak',
                           d['peak_bytes_in_use'], step=step)


__all__ = ['device_memory_stats', 'mfu', 'record_device_stats',
           'FlopCounter', 'FirstStepProbe',
           'cuda_memory', 'DEFAULT_PEAK_TFLOPS']
