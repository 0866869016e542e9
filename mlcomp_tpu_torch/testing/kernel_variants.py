"""Time design variants of the flash-attention backward kernels against
the shipped ones, to show what holds them back.

    python -m mlcomp_tpu_torch.testing.kernel_variants [--iters 20]
        [--baseline OTHER/csrc/flash_attention_bwd.cu]

Needs one CUDA card and ``nvcc``. Each variant below is a textual edit of
``csrc/flash_attention_bwd.cu``, built in a temporary directory as
``kernel_faults`` builds its faults (the checkout is not touched), and
so is the shipped source itself; ``--baseline`` adds another version of
the file with the same C interface (an earlier commit's, say), built
beside its own ``.cuh`` headers. For each library it prints ptxas's
performance advisories (wgmma serialized: C7512 for register resources,
C7515 for non-wgmma definitions of accumulator registers) and any
spills, then the dq and dkv kernels' times at both training shapes
(``kernel_check.BACKWARD_SHAPES[:2]``: the flagship's 16 heads, the wide
LM's 32; CUDA events), every library in turns and twice: shipped,
baseline, variants, then backwards. Variants marked ``wrong`` drop work
and give wrong gradients; they time what the dropped work costs. The
others are held by ``backward_check`` at the flagship shape, and their
line says whether the bounds hold.
"""

import argparse
import os
import re
import subprocess
import tempfile

import torch

from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.ops import flash_attention as fa
from mlcomp_tpu_torch.testing.kernel_check import (
    BACKWARD_SHAPES, backward_check, backward_ok, qkv_views,
)
from mlcomp_tpu_torch.testing.kernel_faults import (
    BACKWARD_KERNEL, _with_library, build_faults,
)

_DQ_WAIT = '''        // overlapping it with the next tile's S and dP products makes
        // ptxas serialize every wgmma of the kernel (C7515): measured
        // slower
        wgmma_wait<0>();
'''
_DKV_RS = ('Tl::mn_major(Qc, BLOCK_M, kk));\n        }\n        '
           'wgmma_commit();\n')

#: name -> (gives the right gradients, [(text of the source, its
#: replacement), ...])
VARIANTS = {
    'two_stages': (True, [('constexpr int STAGES = 3;',
                           'constexpr int STAGES = 2;')]),
    # dq: the next tile's S and dP issued behind the dQ product
    'dq_score_products_overlapped': (True, [(_DQ_WAIT, '')]),
    # dkv: dV and dK waited on before the next tile's S^T and dP^T
    'dkv_gradient_products_waited': (True, [
        (_DKV_RS, _DKV_RS + '        wgmma_wait<0>();\n')]),
    # dkv: 32-query tiles (half the S^T, dP^T, P and dS registers)
    'dkv_32_query_tiles': (True, [('return D == 128 ? 32 : 64;',
                                   'return 32;')]),
    # the causal and ragged-end mask dropped
    'no_mask_pass': (False, [
        ('if ((k0 + BLOCK_N > p.T) || (p.causal && k0 + BLOCK_N - 1 > '
         'wrow0)) {', 'if (false) {'),
        ('if ((qs + BLOCK_M > p.T) || (p.causal && wk0 + 15 > qs)) {',
         'if (false) {')]),
    # P = S: no ex2 (and no FFMA with the lse)
    'no_exp': (False, [
        ('fast_exp2(fmaf(sc[4 * n + e], scale_log2, -lse_r[i]))',
         'sc[4 * n + e]'),
        ('fast_exp2(\n                fmaf(sc[4 * n + e], scale_log2, '
         '-lse_c[qi] * LOG2E))', 'sc[4 * n + e]')]),
    # the dQ, dV and dK products dropped (the math feeding them is then
    # dead code too): what the loads and the score products cost
    'no_gradient_products': (False, [
        ('for (int kk = 0; kk < BLOCK_N / 16; ++kk) {\n          Wgmma',
         'for (int kk = 0; kk < 0; ++kk) {\n          Wgmma'),
        ('for (int kk = 0; kk < BLOCK_M / 16; ++kk) {\n          Wgmma',
         'for (int kk = 0; kk < 0; ++kk) {\n          Wgmma')]),
}


def _advisories(log: str) -> list:
    """ptxas's serialization advisories and nonzero spills, shortened to
    (code, kernel, D) and the spill line."""
    out = []
    for line in log.splitlines():
        m = re.search(r'\((C75\d\d)\).*(fa_bwd_\w+?_kernel)I(\w+?)Li(\d+)E',
                      line)
        if m:
            out.append(f'{m.group(1)} {m.group(2)}<{m.group(3)}, '
                       f'{m.group(4)}>')
        elif 'spill' in line and ' 0 bytes spill stores' not in line:
            out.append(line.strip())
    return out


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _build_baseline(source: str, out_dir: str, logs: dict) -> str:
    """The library of another version of the backward source, compiled
    with the package's flags beside its own headers."""
    so = os.path.join(out_dir, 'baseline.so')
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, '-I',
         os.path.dirname(os.path.abspath(source)), '-o', so, source],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'baseline did not build:\n{proc.stdout}'
                           f'{proc.stderr}')
    logs['baseline'] = proc.stdout + proc.stderr
    return so


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--baseline', default=None,
                        help='another flash_attention_bwd.cu to time')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('FAIL: no CUDA card', flush=True)
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True).stdout
    print(f'[variants] card={card.strip()!r}', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    with tempfile.TemporaryDirectory(prefix='kernel_variants_') as tmp:
        logs = {}
        libs = build_faults(tmp, BACKWARD_KERNEL, {
            'shipped': [], **{n: e for n, (_, e) in VARIANTS.items()}}, logs)
        if args.baseline:
            libs = {'shipped': libs.pop('shipped'),
                    'baseline': _build_baseline(args.baseline, tmp, logs),
                    **libs}
        for name in libs:
            lines = _advisories(logs[name])
            print(f'[variants] {name} ptxas: '
                  + ('; '.join(lines) if lines else 'no advisory, no spill'),
                  flush=True)
        for name, (right, _) in VARIANTS.items():
            if right:
                r = _with_library(BACKWARD_KERNEL, libs[name],
                                  lambda: backward_check(BACKWARD_SHAPES[0],
                                                         gen))
                print(f'[variants] {name} bounds_hold='
                      f'{backward_ok(r, BACKWARD_SHAPES[0][4])}', flush=True)
        for shape in BACKWARD_SHAPES[:2]:
            _time_shape(shape, libs, gen, args.iters)
    return 0


def _time_shape(shape, libs: dict, gen, iters: int):
    """dq and dkv times of every library at ``shape``, in turns, twice."""
    b, t, h, d, dtype, causal = shape
    q, k, v = qkv_views(b, t, h, d, dtype, gen)
    do = torch.randn((b, t, h, d), generator=gen, device='cuda',
                     dtype=torch.float32).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                          with_lse=True)
    delta = fa.attention_delta(out, do)

    def times() -> tuple:
        return (_time_ms(lambda: fa.flash_attention_backward_dq(
                    q, k, v, do, lse, delta, causal=causal), iters),
                _time_ms(lambda: fa.flash_attention_backward_dkv(
                    q, k, v, do, lse, delta, causal=causal), iters))

    ms = {}
    for name in list(libs) + list(libs)[::-1]:
        ms.setdefault(name, []).append(_with_library(
            BACKWARD_KERNEL, libs[name], times))
    for name, runs in ms.items():
        wrong = '' if name not in VARIANTS or VARIANTS[name][0] \
            else ' (wrong gradients: a cost probe)'
        print(f'[variants] {name} shape={shape[:4]} '
              f'dq_ms={",".join(f"{r[0]:.4f}" for r in runs)} '
              f'dkv_ms={",".join(f"{r[1]:.4f}" for r in runs)}{wrong}',
              flush=True)
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()


if __name__ == '__main__':
    raise SystemExit(main())
