"""Time design variants of the hand-written kernels against the shipped
ones, to show what holds them back: the flash-attention kernels, the
weight-only int8 matmul, the serving stack and the fused norm.

    python -m mlcomp_tpu_torch.testing.kernel_variants [--iters 20]
        [--only forward|backward|int8|stack|norm]
        [--baseline OTHER/csrc/flash_attention_fwd.cu]
        [--baseline OTHER/csrc/flash_attention_bwd.cu]
        [--baseline OTHER/csrc/int8_matmul.cu]
        [--baseline OTHER/csrc/serving_stack.cu]
        [--baseline OTHER/csrc/fused_norm.cu]

Needs one CUDA card and ``nvcc``. Each variant below is a textual edit of
``csrc/flash_attention_fwd.cu`` (``FORWARD_VARIANTS``) or
``csrc/flash_attention_bwd.cu`` (``VARIANTS``), built in a temporary
directory as ``kernel_faults`` builds its faults (the checkout is not
touched), and so is the shipped source itself; ``--baseline`` adds
another version of either file with the same C interface (an earlier
commit's, say), built beside its own ``.cuh`` headers. For each library
it prints ptxas's performance advisories (wgmma serialized: C7512 for
register resources, C7515 for non-wgmma definitions of accumulator
registers) and any spills, then the kernels' times (CUDA events), every
library in turns and twice: shipped, baseline, variants, then backwards.
The forward runs at the serving shape (``kernel_check.ATTENTION_SHAPES[0]``)
and with its lse at the flagship's training shape
(``kernel_check.BACKWARD_SHAPES[0]``); dq and dkv at both training shapes
(``kernel_check.BACKWARD_SHAPES[:2]``: the flagship's 16 heads, the wide
LM's 32). Variants marked ``wrong`` drop work and give wrong results;
they time what the dropped work costs. The others are held by the
card-side checks (the forward's row error at the serving shape and its
lse at the training shape; ``backward_check`` at the flagship shape),
and their line says whether the bounds hold.

The int8 matmul (``INT8_VARIANTS`` of ``csrc/int8_matmul.cu``) is timed
at the four timed shapes of ``chip_smoke.py``'s ``[kernel-int8]``
(``kernel_check.INT8_SHAPES[:4]``) beside ``torch.matmul`` on a bf16
weight; the stack (``STACK_VARIANTS`` of ``csrc/serving_stack.cu``) at
the bench's 8 layers of 8192² at M = 64 in int8 and bf16 and at one
layer. Each library is called through its own C interface, so a
baseline from before the fused epilogue (an ``int8_matmul`` without its
bias and output-type arguments) times the same product. Their variants
that give the right result are held by ``int8_check`` at every
``INT8_SHAPES`` shape and ``stack_check`` at every ``STACK_SHAPES``
shape.

The fused norm (``NORM_VARIANTS``: edits of ``csrc/norm_common.cuh``,
which both norm kernels include, so such a variant is built for the
forward and the backward, or of one kernel's source) is timed at the
four CIFAR sites of the
batch-512 step (``kernel_check.cifar_norm_sites(512)``, bf16, with the
ReLU) on inputs rotated through more than the L2 cache, by CUDA events
over back-to-back calls (host gaps included) and by the profiler's
device time; a baseline ``fused_norm.cu`` from before the one-launch
design (its C interface has no barrier argument) times beside the
forward. The variants are
held by ``norm_check`` and ``norm_bwd_check`` at every ``NORM_SHAPES``
shape.
"""


import argparse
import ctypes
import os
import re
import subprocess
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.ops import flash_attention as fa
from mlcomp_tpu_torch.ops import fused_norm
from mlcomp_tpu_torch.testing.kernel_check import (
    ATTENTION_ROW_TOL, ATTENTION_SHAPES, BACKWARD_SHAPES, INT8_SHAPES,
    LSE_TOL, NORM_SHAPES, STACK_SHAPES, backward_check, backward_ok,
    cifar_norm_sites, int8_check, int8_inputs, int8_ok, norm_bwd_check,
    norm_bwd_inputs, norm_bwd_ok, norm_check, norm_ok, qkv_views,
    stack_check, stack_inputs, stack_ok,
)
from mlcomp_tpu_torch.testing.kernel_faults import (
    BACKWARD_KERNEL, INT8_KERNEL, KERNEL, NORM_BWD_KERNEL, NORM_KERNEL,
    STACK_KERNEL, _with_library, build_faults, check, check_lse,
)

_FWD_MASK_PASS = ('      if (k0 + BLOCK_N > p.T || (p.causal && k0 + BLOCK_N '
                  '- 1 > wrow0)) {')
_FWD_PV = ('for (int kk = 0; kk < BLOCK_N / 16; ++kk)\n'
           '    Wgmma<T, D>::template rs<1>')
_FWD_S = ('for (int kk = 0; kk < D / 16; ++kk)\n'
          '    Wgmma<T, N>::ss(sc,')

# the softmax of tile kt after tile kt - 1's PV product is done
_OVERLAP = ('      wgmma_wait<1>();\n', '      wgmma_wait<0>();\n')
# the consumers issue their products without taking turns
_TURNS = [('  named_bar_sync(TURN_BAR + wg, 2 * WG);\n}', '}'),
          ('  named_bar_arrive(TURN_BAR + wg, 2 * WG);\n}', '}')]

#: name -> (gives the right output, [(text of the forward source, its
#: replacement), ...]); the shipped forward overlaps each consumer's
#: softmax with its own PV product and has its three consumers take turns
FORWARD_VARIANTS = {
    # FA3's intra-warpgroup overlap alone, the turns alone, neither
    'fwd_overlap_only': (True, _TURNS),
    'fwd_pingpong_only': (True, [_OVERLAP]),
    'fwd_neither': (True, [_OVERLAP, *_TURNS]),
    # 64-key K/V tiles at every head dim (half the S and P registers)
    'fwd_block_n_64': (True, [('return D == 128 ? 64 : 128;',
                               'return 64;')]),
    'fwd_two_stages': (True, [('constexpr int STAGES = 4;',
                               'constexpr int STAGES = 2;')]),
    'fwd_three_stages': (True, [('constexpr int STAGES = 4;',
                                 'constexpr int STAGES = 3;')]),
    'fwd_five_stages': (True, [('constexpr int STAGES = 4;',
                                'constexpr int STAGES = 5;')]),
    # two consumers: 128 query rows a block, each K/V tile read by half
    # as many blocks again
    'fwd_two_consumers': (True, [('constexpr int CONSUMERS = 3;',
                                  'constexpr int CONSUMERS = 2;')]),
    # the consumers' branch after setmaxnreg dropped (it never returns)
    'fwd_no_branch_after_setmaxnreg': (True, [(
        '    if (blockIdx.x >= n_q_tiles * p.B * p.H) return;\n', '')]),
    # cost probes: the mask pass, the ex2 (P = S), the PV product, both
    # products dropped
    'fwd_no_mask_pass': (False, [(_FWD_MASK_PASS, '      if (false) {')]),
    'fwd_no_exp': (False, [(
        'fast_exp2(fmaf(sc[4 * n + e], scale_log2, -mx[e / 2]))',
        'sc[4 * n + e]')]),
    'fwd_no_pv_product': (False, [(
        _FWD_PV, _FWD_PV.replace('kk < BLOCK_N / 16', 'kk < 0'))]),
    'fwd_no_products': (False, [
        (_FWD_PV, _FWD_PV.replace('kk < BLOCK_N / 16', 'kk < 0')),
        (_FWD_S, _FWD_S.replace('kk < D / 16', 'kk < 0'))]),
}


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


_INT8_PRODUCTS = '''    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int rg = 0; rg < C::RG; ++rg)
        Wgmma<bf16, C::BN>::template rs<0>(acc[rg], a[rg][kk],
                                           k_major_desc(xs, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
'''
_INT8_CONVERT = ('        a_fragment(a[rg][kk], ws, 64 * (wg * C::RG + rg) + '
                 '16 * warp + g,\n                   kk, t);')

#: name -> (gives the right output, [(text of csrc/int8_matmul.cu, its
#: replacement), ...]); the shipped kernel takes 128 channels x 256
#: tokens with a 5-stage ring at large M, 128 channels x 64 tokens with
#: an 8-stage ring at M <= 64
INT8_VARIANTS = {
    'int8_large_4_stages': (True, [('using Large = Config<1, 256, 5>;',
                                    'using Large = Config<1, 256, 4>;')]),
    # 128-token tiles (m64n128k16): half the accumulators, twice the
    # weight tile's reads per token
    'int8_large_128_tokens': (True, [('using Large = Config<1, 256, 5>;',
                                      'using Large = Config<1, 128, 5>;')]),
    # 256 channels by 128 tokens (two row groups a consumer)
    'int8_large_256_channels': (True, [(
        'using Large = Config<1, 256, 5>;',
        'using Large = Config<2, 128, 6>;')]),
    'int8_small_4_stages': (True, [('using Small = Config<1, 64, 8>;',
                                    'using Small = Config<1, 64, 4>;')]),
    # 256 channels a block at M <= 64 (two row groups a consumer): half
    # the x tiles for the weight, half the blocks to split K over
    'int8_small_256_channels': (True, [('using Small = Config<1, 64, 8>;',
                                        'using Small = Config<2, 64, 8>;')]),
    # cost probes: the products dropped; the int8 conversion dropped
    # (zeros multiplied)
    'int8_no_products': (False, [(_INT8_PRODUCTS, '')]),
    'int8_no_convert': (False, [(
        _INT8_CONVERT, '        a[rg][kk][0] = a[rg][kk][1] = a[rg][kk][2] = '
                       'a[rg][kk][3] = 0u;')]),
}

_STACK_PRODUCT = '''            if (k0 + kt * R::W_BK < p.K)
              stage_product(acc, ring + s * R::STAGE,
                            xs + kt * (R::W_BK / BK) * (MT * 128), row, t,
                            WT());
'''
#: name -> (gives the right output, [(text of csrc/serving_stack.cu, its
#: replacement), ...]); the shipped stack has a 64 KB weight ring and
#: two grid barriers a layer (the max, then the fed activation)
STACK_VARIANTS = {
    'stack_ring_48k': (True, [('constexpr int RING_BYTES = 64 * 1024;',
                               'constexpr int RING_BYTES = 48 * 1024;')]),
    # cost probes: the products dropped; the feed's second grid barrier
    # dropped (a race); every layer boundary's synchronization dropped
    'stack_no_products': (False, [(_STACK_PRODUCT, '')]),
    'stack_no_second_grid_barrier': (False, [(
        '    feed_shares(p, denom, cluster, clusters, rank, ctid);\n'
        '    grid_barrier(p.bar, ++arrivals * gridDim.x, ctid);\n',
        '    feed_shares(p, denom, cluster, clusters, rank, ctid);\n')]),
}


NORM_HEADER = 'norm_common.cuh'
_NORM_FWD = NORM_KERNEL + '.cu'
#: name -> (right, [(file, text, replacement)]): edits of the header both
#: norm kernels include, or of one kernel's source (that kernel alone is
#: built with it)
NORM_VARIANTS = {
    # the design the one-launch forward started from: the resident rows
    # brought into shared memory by bulk asynchronous copies (TMA,
    # evict_first), in 8 pieces with an mbarrier each, issued by one
    # thread at the start and waited on before their rows are summed
    'norm_resident_by_bulk_copies': (True, [
        (NORM_HEADER, 'constexpr int SMEM_BYTES = 232448;',
         'constexpr int SMEM_BYTES = 232448 - 128;'),
        (_NORM_FWD, '  using Row = Row8<T, VECTOR>;\n',
         '  using Row = Row8<T, VECTOR>;\n'
         '  __shared__ uint64_t bars[8];\n'
         '  const int per = (rows.res + 7) / 8;\n'
         '  if (threadIdx.x == 0) {\n'
         '    for (int j = 0; j < 8; ++j) flash::mbar_init(bars + j, 1);\n'
         '    flash::mbar_init_fence();\n'
         '  }\n'
         '  __syncthreads();\n'
         '  if (threadIdx.x == 0 && rows.res > 0) {\n'
         '    const int rb = C * static_cast<int>(sizeof(T));\n'
         '    for (int j = 0; j < 8; ++j) {\n'
         '      const int a = j * per, b = min(rows.res, a + per);\n'
         '      if (a >= b) break;\n'
         '      const uint32_t bytes = static_cast<uint32_t>(b - a) * rb;\n'
         '      flash::mbar_arrive_expect_tx(bars + j, bytes);\n'
         '      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier'
         '::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\\n"'
         '\n'
         '          :: "r"(flash::smem_u32(tile + static_cast<size_t>(a) * '
         'C)),\n'
         '             "l"(reinterpret_cast<uint64_t>(x + static_cast<size_t>'
         '(rows.r0 + a) * C)),\n'
         '             "r"(bytes), "r"(flash::smem_u32(bars + j)), '
         '"l"(drop) : "memory");\n'
         '    }\n'
         '  }\n'),
        (_NORM_FWD,
         '      if constexpr (VECTOR)\n'
         '        sweep<U>(ty, rows.res, lanes, [&](int rr) {\n'
         '          return load_row<T, VECTOR>(\n'
         '              x + static_cast<size_t>(rows.r0 + rr) * C + c0, n, '
         'drop);\n'
         '        }, [&](int rr, const Row& raw) {\n'
         '          store_tile(tile + static_cast<size_t>(rr) * C + c0, '
         'raw);\n'
         '          add(raw);\n'
         '        });\n',
         '      if constexpr (VECTOR) {\n'
         '        int waited = 0;\n'
         '        for (int rr = ty; rr < rows.res; rr += lanes) {\n'
         '          for (const int j = rr / per; waited <= j; ++waited)\n'
         '            flash::mbar_wait(bars + waited, 0);\n'
         '          add(load_tile(tile + static_cast<size_t>(rr) * C + '
         'c0));\n'
         '        }\n'
         '      }\n')]),
    # no row resident in shared memory: every row read twice from
    # device memory (or L2), as the three-launch design did
    'norm_no_residency': (True, [(
        NORM_HEADER,
        'constexpr int RESIDENT_BYTES = SMEM_BYTES - SCRATCH_BYTES;',
        'constexpr int RESIDENT_BYTES = 0;')]),
    # no L2 hints: normal eviction priority for the loads and the stores
    'norm_no_l2_hints': (True, [
        (NORM_HEADER, 'createpolicy.fractional.L2::evict_first.b64',
         'createpolicy.fractional.L2::evict_normal.b64'),
        (NORM_HEADER, 'createpolicy.fractional.L2::evict_last.b64',
         'createpolicy.fractional.L2::evict_normal.b64'),
        (NORM_HEADER, '__stcs(static_cast<uint4*>(p), v);',
         '*static_cast<uint4*>(p) = v;')]),
}


def _advisories(log: str) -> list:
    """ptxas's wgmma advisories (serialized: C7512, C7515, C7518; a wait
    it injected: C7517) and nonzero spills, shortened to (code, kernel,
    D) — (code, kernel, its configuration) for the int8 kernels — and the
    spill line."""
    out = []
    for line in log.splitlines():
        m = re.search(r'\((C75\d\d)\).*(fa_\w+?_kernel)I(\w+?)Li(\d+)E',
                      line)
        g = re.search(r'\((C75\d\d)\).*?\d+((?:int8|stack)_\w+?_kernel)'
                      r'(\w*)', line)
        if m:
            out.append(f'{m.group(1)} {m.group(2)}<{m.group(3)}, '
                       f'{m.group(4)}>')
        elif g:
            out.append(f'{g.group(1)} {g.group(2)} {g.group(3)[:40]}')
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
    """The library of another version of a kernel source, compiled with
    the package's flags beside its own headers."""
    so = os.path.join(out_dir, os.path.basename(source) + '.baseline.so')
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
    parser.add_argument('--only',
                        choices=('forward', 'backward', 'int8', 'stack',
                                 'norm'),
                        default=None, help='time one kernel source only')
    parser.add_argument('--baseline', action='append', default=[],
                        help='another flash_attention_fwd.cu, '
                             'flash_attention_bwd.cu, int8_matmul.cu, '
                             'serving_stack.cu or fused_norm.cu to time')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('FAIL: no CUDA card', flush=True)
        return 1
    baselines = {}
    for path in args.baseline:
        kernel = os.path.splitext(os.path.basename(path))[0]
        if kernel not in (KERNEL, BACKWARD_KERNEL, INT8_KERNEL,
                          STACK_KERNEL, NORM_KERNEL):
            parser.error(f'--baseline {path}: not a kernel source of '
                         f'the port')
        baselines[kernel] = path
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True).stdout
    print(f'[variants] card={card.strip()!r}', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    with tempfile.TemporaryDirectory(prefix='kernel_variants_') as tmp:
        if args.only in (None, 'forward'):
            libs = _libraries(tmp, KERNEL, FORWARD_VARIANTS,
                              baselines.get(KERNEL))
            _check_variants(libs, KERNEL, FORWARD_VARIANTS, _forward_bounds)
            _time_forward(libs, gen, args.iters)
        if args.only in (None, 'backward'):
            libs = _libraries(tmp, BACKWARD_KERNEL, VARIANTS,
                              baselines.get(BACKWARD_KERNEL))
            _check_variants(libs, BACKWARD_KERNEL, VARIANTS,
                            lambda: _backward_bounds(gen))
            for shape in BACKWARD_SHAPES[:2]:
                _time_shape(shape, libs, gen, args.iters)
        if args.only in (None, 'int8'):
            libs = _libraries(tmp, INT8_KERNEL, INT8_VARIANTS,
                              baselines.get(INT8_KERNEL))
            _check_variants(libs, INT8_KERNEL, INT8_VARIANTS,
                            lambda: _shapes_bounds(INT8_SHAPES, int8_check,
                                                   lambda r, s: int8_ok(r),
                                                   gen))
            _time_int8(libs, gen, args.iters, baselines.get(INT8_KERNEL))
        if args.only in (None, 'stack'):
            libs = _libraries(tmp, STACK_KERNEL, STACK_VARIANTS,
                              baselines.get(STACK_KERNEL))
            _check_variants(libs, STACK_KERNEL, STACK_VARIANTS,
                            lambda: _shapes_bounds(
                                STACK_SHAPES, stack_check,
                                lambda r, s: stack_ok(r, s[0]), gen))
            _time_stack(libs, gen, args.iters)
        if args.only in (None, 'norm'):
            fwd = _libraries(tmp, NORM_KERNEL, _norm_variants(NORM_KERNEL),
                             baselines.get(NORM_KERNEL))
            bwd = _libraries(tmp, NORM_BWD_KERNEL,
                             _norm_variants(NORM_BWD_KERNEL), None)
            _check_norm_variants(fwd, bwd, gen)
            _time_norm(fwd, bwd, gen, args.iters)
    return 0


def _forward_bounds() -> str:
    """The forward's row error at the serving shape and its lse error at
    the flagship's training shape, against their bounds."""
    row, _ = check(ATTENTION_SHAPES[0], 0)
    lse_err = check_lse(BACKWARD_SHAPES[0], 0)
    ok = row <= ATTENTION_ROW_TOL[ATTENTION_SHAPES[0][4]] and \
        lse_err <= LSE_TOL
    return f'row_err={row:.3e} lse_err={lse_err:.3e} bounds_hold={ok}'


def _backward_bounds(gen) -> str:
    """Whether ``backward_check``'s bounds hold at the flagship shape."""
    r = backward_check(BACKWARD_SHAPES[0], gen)
    return f'bounds_hold={backward_ok(r, BACKWARD_SHAPES[0][4])}'


def _shapes_bounds(shapes, check_fn, ok_fn, gen) -> str:
    """Whether ``check_fn``'s bounds hold at every shape."""
    failed = [s for s in shapes if not ok_fn(check_fn(s, gen), s)]
    torch.cuda.empty_cache()
    return f'bounds_hold={not failed}' + (f' failing={failed}'
                                           if failed else '')


def _check_variants(libs: dict, kernel: str, variants: dict, bounds):
    """``bounds()``'s line for each variant that gives the right
    result, with its library loaded."""
    for name, (right, _) in variants.items():
        if right:
            print(f'[variants] {name} '
                  + _with_library(kernel, libs[name], bounds), flush=True)


def _libraries(tmp: str, kernel: str, variants: dict, baseline) -> dict:
    """{name: library} of the shipped source, the baseline (if any) and
    each variant of ``kernel``, with each build's ptxas advisories
    printed."""
    logs = {}
    libs = build_faults(tmp, kernel, {
        'shipped': [], **{n: e for n, (_, e) in variants.items()}}, logs)
    if baseline:
        libs = {'shipped': libs.pop('shipped'),
                'baseline': _build_baseline(baseline, tmp, logs), **libs}
    for name in libs:
        lines = _advisories(logs[name])
        print(f'[variants] {kernel} {name} ptxas: '
              + ('; '.join(lines) if lines else 'no advisory, no spill'),
              flush=True)
    return libs


def _time_in_turns(libs: dict, kernel: str, fn) -> dict:
    """{name: [result, result]} of ``fn()`` with each library of
    ``kernel`` loaded, every library in turns, then in reverse order."""
    runs = {}
    for name in list(libs) + list(libs)[::-1]:
        runs.setdefault(name, []).append(
            _with_library(kernel, libs[name], fn))
    return runs


def _time_forward(libs: dict, gen, iters: int):
    """The forward's times of every library, in turns, twice: at the
    serving shape without lse, at the flagship's training shape with."""
    for shape, with_lse in ((ATTENTION_SHAPES[0], False),
                            (BACKWARD_SHAPES[0], True)):
        b, t, h, d, dtype, causal = shape
        q, k, v = qkv_views(b, t, h, d, dtype, gen)
        ms = _time_in_turns(libs, KERNEL, lambda: _time_ms(
            lambda: fa.flash_attention_forward(
                q, k, v, causal=causal, with_lse=with_lse), iters))
        for name, runs in ms.items():
            wrong = '' if name not in FORWARD_VARIANTS or \
                FORWARD_VARIANTS[name][0] else ' (wrong output: a cost probe)'
            print(f'[variants] {name} shape={shape[:4]} lse={with_lse} '
                  f'fwd_ms={",".join(f"{r:.4f}" for r in runs)}{wrong}',
                  flush=True)
        del q, k, v
        torch.cuda.empty_cache()


def _time_shape(shape, libs: dict, gen, iters: int):
    """dq and dkv times of every library at ``shape``, in turns, twice."""
    b, t, h, d, dtype, causal = shape
    q, k, v = qkv_views(b, t, h, d, dtype, gen)
    do = torch.randn((b, t, h, d), generator=gen, device='cuda',
                     dtype=torch.float32).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                          with_lse=True)
    delta = fa.attention_delta(out, do)
    ms = _time_in_turns(libs, BACKWARD_KERNEL, lambda: (
        _time_ms(lambda: fa.flash_attention_backward_dq(
            q, k, v, do, lse, delta, causal=causal), iters),
        _time_ms(lambda: fa.flash_attention_backward_dkv(
            q, k, v, do, lse, delta, causal=causal), iters)))
    for name, runs in ms.items():
        wrong = '' if name not in VARIANTS or VARIANTS[name][0] \
            else ' (wrong gradients: a cost probe)'
        print(f'[variants] {name} shape={shape[:4]} '
              f'dq_ms={",".join(f"{r[0]:.4f}" for r in runs)} '
              f'dkv_ms={",".join(f"{r[1]:.4f}" for r in runs)}{wrong}',
              flush=True)
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()


def _int8_caller(path: str, fused: bool):
    """f(x, w_qt, scale, out) launching the int8 library at ``path``
    through its own C interface: with the fused epilogue's bias and
    output-type arguments (``fused``; f32 out, no bias) or without them
    (an earlier source)."""
    lib = ctypes.CDLL(path)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.int8_matmul
    fn.argtypes = ([ptr] * 5 + [i, ptr] + [i] * 3 + [ptr]) if fused \
        else ([ptr] * 5 + [i] * 3 + [ptr])
    fn.restype = i
    lib.int8_matmul_workspace.argtypes = [i, i, i]
    lib.int8_matmul_workspace.restype = ctypes.c_longlong

    def call(x, w, scale, out):
        m, k = x.shape
        n = w.shape[0]
        need = lib.int8_matmul_workspace(m, n, k)
        part = torch.empty(max(need, 1), dtype=torch.float32,
                           device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), w.data_ptr(), scale.data_ptr())
        if fused:
            err = fn(*args, None, out.data_ptr(), 0, part.data_ptr(), m, n,
                     k, stream)
        else:
            err = fn(*args, out.data_ptr(), part.data_ptr(), m, n, k, stream)
        if err:
            raise RuntimeError(f'int8_matmul at {path}: CUDA error {err}')
    return call


def _time_int8(libs: dict, gen, iters: int, baseline=None):
    """Each library's int8 product at the smoke's four timed shapes, in
    turns, twice, beside ``torch.matmul`` on a bf16 weight; ``baseline``
    is the source the 'baseline' library was built from."""
    fused = {name: True for name in libs}
    if baseline:
        with open(baseline) as fh:
            fused['baseline'] = 'const float* bias' in fh.read()
    for shape in INT8_SHAPES[:4]:
        m, k, n = shape
        # the bench's 67 MB weight is read from device memory: turns over
        # copies that together exceed the 50 MB L2
        copies = 3 if m <= 64 else 1
        inputs = [int8_inputs(m, k, n, gen) for _ in range(copies)]
        out = torch.empty((m, n), dtype=torch.float32, device='cuda')
        n_iter = iters * (5 if m <= 64 else 1)
        runs = {}
        for name in list(libs) + list(libs)[::-1]:
            call = _int8_caller(libs[name], fused[name])

            def rotate():
                for x, w, s in inputs:
                    call(x, w, s, out)
            runs.setdefault(name, []).append(
                _time_ms(rotate, n_iter) / copies)
        w_bf16 = [(x, w.to(torch.bfloat16), s) for x, w, s in inputs]

        def library():
            for x, w, s in w_bf16:
                torch.matmul(x, w.t()) * s
        lib_ms = _time_ms(library, n_iter) / copies
        for name, r in runs.items():
            wrong = '' if name not in INT8_VARIANTS or \
                INT8_VARIANTS[name][0] else ' (wrong output: a cost probe)'
            print(f'[variants] {name} shape={m}x{k}x{n} '
                  f'ms={",".join(f"{t:.4f}" for t in r)} '
                  f'library_ms={lib_ms:.4f}{wrong}', flush=True)
        del inputs, w_bf16, out
        torch.cuda.empty_cache()


def _stack_caller(path: str):
    """f(x, w, scales, layers) launching the stack library at ``path``
    (the shipped one's C interface, which its predecessor shares)."""
    lib = ctypes.CDLL(path)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.serving_stack
    fn.argtypes = [ptr] * 6 + [i] * 5 + [ptr]
    fn.restype = i
    lib.serving_stack_slots.argtypes = [i]
    lib.serving_stack_slots.restype = i

    def call(x, w, scales):
        n_l, _, k = w.shape
        m = x.shape[0]
        out = torch.empty((m, k), dtype=torch.float32, device=x.device)
        x_buf = torch.empty_like(x)
        scratch = torch.empty(lib.serving_stack_slots(k),
                              dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), x_buf.data_ptr(), w.data_ptr(),
                 None if scales is None else scales.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), n_l, m, k,
                 0 if w.dtype == torch.int8 else 1, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'serving_stack at {path}: CUDA error {err}')
    return call


def _time_stack(libs: dict, gen, iters: int):
    """Each stack library at 8 layers of 8192² at M = 64 (int8, bf16) and
    at one int8 layer, in turns, twice."""
    layers, m, k = STACK_SHAPES[0][:3]
    operands = {str(wd)[6:]: stack_inputs(layers, m, k, wd, gen)
                for wd in (torch.int8, torch.bfloat16)}
    runs = {}
    for name in list(libs) + list(libs)[::-1]:
        call = _stack_caller(libs[name])
        t = {wd: _time_ms(lambda: call(x, w, s), iters * 2)
             for wd, (x, w, s) in operands.items()}
        x, w, s = operands['int8']
        w1, s1 = w[:1].contiguous(), s[:1].contiguous()
        t['int8_1_layer'] = _time_ms(lambda: call(x, w1, s1), iters * 2)
        runs.setdefault(name, []).append(t)
    for name, r in runs.items():
        wrong = '' if name not in STACK_VARIANTS or \
            STACK_VARIANTS[name][0] else ' (wrong output: a cost probe)'
        print(f'[variants] {name} stack={layers}x{m}x{k} ' + ' '.join(
            f'{key}_ms={",".join(f"{t[key]:.4f}" for t in r)}'
            for key in r[0]) + wrong, flush=True)
    del operands
    torch.cuda.empty_cache()



def _norm_variants(kernel: str) -> dict:
    """The norm variants of ``kernel``: those that edit its source, and
    those that edit the header alone."""
    return {name: v for name, v in NORM_VARIANTS.items()
            if kernel + '.cu' in {f for f, _, _ in v[1]}
            or {f for f, _, _ in v[1]} == {NORM_HEADER}}


def _check_norm_variants(fwd: dict, bwd: dict, gen):
    """Whether each norm variant holds ``norm_check`` and
    ``norm_bwd_check`` at every ``NORM_SHAPES`` shape."""
    for name in NORM_VARIANTS:
        line = []
        if name in fwd:
            line.append('forward ' + _with_library(
                NORM_KERNEL, fwd[name], lambda: _shapes_bounds(
                    NORM_SHAPES, norm_check, lambda r, s: norm_ok(r, s[2]),
                    gen)))
        if name in bwd:
            line.append('backward ' + _with_library(
                NORM_BWD_KERNEL, bwd[name], lambda: _shapes_bounds(
                    NORM_SHAPES, norm_bwd_check, norm_bwd_ok, gen)))
        print(f'[variants] {name} ' + '; '.join(line), flush=True)


def _norm_caller(path: str):
    """f(x, gamma, beta) launching the forward library at ``path``
    through its own C interface: the one-launch kernel's (scratch sized
    by ``fused_norm_scratch_floats``, the grid barrier's words) or the
    three-launch one's (``fused_norm_scratch_rows``, no barrier)."""
    lib = ctypes.CDLL(path)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.fused_norm_act
    one_launch = hasattr(lib, 'fused_norm_scratch_floats')
    fn.argtypes = [ptr] * (8 if one_launch else 7) + [i] * 3 + [
        ctypes.c_float, i, ptr]
    fn.restype = i
    size = lib.fused_norm_scratch_floats if one_launch \
        else lib.fused_norm_scratch_rows
    size.argtypes = [i, i]
    size.restype = i

    def call(x, gamma, beta):
        r, c = x.shape
        y = torch.empty_like(x)
        mean, var = (torch.empty(c, device=x.device) for _ in range(2))
        scratch = torch.empty(size(r, c) * (1 if one_launch else c),
                              device=x.device)
        bar = [fused_norm._barrier(x.device).data_ptr()] if one_launch \
            else []
        err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 y.data_ptr(), mean.data_ptr(), var.data_ptr(),
                 scratch.data_ptr(), *bar, r, c, 1, 1e-5, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'fused_norm at {path}: CUDA error {err}')
    return call


def _time_norm(fwd: dict, bwd: dict, gen, iters: int):
    """The forward of every library and the backward of every library
    but the baseline at the CIFAR sites, in turns, twice, on inputs
    rotated through more than the L2 cache."""
    for r, c in cifar_norm_sites(512):
        copies = max(8, -(-(256 << 20) // (r * c * 2)))
        inputs = [norm_bwd_inputs(r, c, torch.bfloat16, gen)
                  for _ in range(copies)]
        stats = [fused_norm.norm_act_forward(x, g, b)[1:]
                 for x, g, b, _ in inputs]
        n_iter = max(iters, 2 * copies)

        def rotate(fn, args):
            """(CUDA-event ms a call over back-to-back calls, host gaps
            included; the kernels' device ms a call, profiler)."""
            count = [0]

            def step():
                fn(*args[count[0] % len(args)])
                count[0] += 1
            events = _time_ms(step, n_iter)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for a in args:
                    fn(*a)
                torch.cuda.synchronize()
            device_us = sum(getattr(e, 'self_device_time_total', 0.0)
                            for e in prof.key_averages())
            return events, device_us / len(args) / 1e3
        runs = {}
        for name in list(fwd) + list(fwd)[::-1]:
            t = {'fwd_ms': rotate(_norm_caller(fwd[name]),
                                  [a[:3] for a in inputs])}
            if name in bwd:
                t['bwd_ms'] = _with_library(
                    NORM_BWD_KERNEL, bwd[name], lambda: rotate(
                        fused_norm.norm_act_backward_kernel,
                        [(x, g, b, m, v, d) for (x, g, b, d), (m, v)
                         in zip(inputs, stats)]))
            runs.setdefault(name, []).append(t)
        for name, r_ in runs.items():
            print(f'[variants] {name} site={r}x{c} ' + ' '.join(
                f'{key}={",".join(f"{t[key][0]:.4f}" for t in r_)} '
                f'{key[:3]}_device_ms='
                f'{",".join(f"{t[key][1]:.4f}" for t in r_)}'
                for key in r_[0]), flush=True)
        del inputs, stats
        torch.cuda.empty_cache()


if __name__ == '__main__':
    raise SystemExit(main())
