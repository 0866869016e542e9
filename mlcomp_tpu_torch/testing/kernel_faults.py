"""Plant faults in copies of the kernels and read each against the
card-side check, to show the check would catch them.

    python -m mlcomp_tpu_torch.testing.kernel_faults [--seeds 0 1 2]

Needs one CUDA card and ``nvcc``. First the kernels as they stand run at
every shape of ``kernel_check.ATTENTION_SHAPES`` (forward),
``kernel_check.BACKWARD_SHAPES`` (forward with lse, then backward),
``kernel_check.NORM_SHAPES`` (fused norm), ``kernel_check.INT8_SHAPES``
(int8 matmul), ``kernel_check.STACK_SHAPES`` (serving stack) and
``kernel_check.CE_SHAPES`` (cross-entropy, forward and backward) for
each seed, which shows the margin of each tolerance. Then each fault below, a
textual edit of a kernel's ``csrc/*.cu`` (or of a header it includes,
copied beside it) written to a temporary directory (the checkout is not
touched) and built with the package's nvcc flags, runs at the serving
shape (forward faults), the training shape (backward faults) or every
shape of its kernel (norm, int8, stack and CE faults: caught if any
shape fails a bound). Each line gives the errors against their bounds. Exits 1
if a kernel as it stands fails a bound or a planted fault passes them
all.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.ops import flash_attention as fa
from mlcomp_tpu_torch.testing.kernel_check import (
    ATTENTION_ROW_TOL, ATTENTION_SHAPES, BACKWARD_HEAD_TOL, BACKWARD_ROW_TOL,
    BACKWARD_SHAPES, CE_LOSS_TOL, CE_ROW_TOL, CE_SHAPES, INT8_ROW_TOL,
    INT8_SHAPES, NORM_SHAPES, NORM_STAT_TOL, NORM_Y_TOL, STACK_ROW_TOL,
    STACK_SHAPES, backward_check, backward_ok, ce_check, ce_ok, int8_check,
    int8_ok, norm_check, norm_ok, qkv_views, row_relative_error,
    stack_check, stack_ok, stack_tol,
)

KERNEL = 'flash_attention_fwd'
_LIVE_TILE = '    if (!p.causal || k0 <= wrow0 + 16 * MT - 1) {\n'
_MASK = 'if (kc >= p.T || (p.causal && kc > qr)) s[mt][n][e] = NEG_INF;'

#: name -> (text of the forward kernel's source, its faulty replacement)
FAULTS = {
    # rows from 4096 on lose keys 64..127: ~1% of their keys
    'k_tile_skipped_from_row_4096': (
        _LIVE_TILE,
        '    if ((!p.causal || k0 <= wrow0 + 16 * MT - 1) &&\n'
        '        !(kt == 1 && q0 >= 4096)) {\n'),
    # the last 512 rows lose the middle K/V tile
    'mid_k_tile_skipped_in_last_512_rows': (
        _LIVE_TILE,
        '    if ((!p.causal || k0 <= wrow0 + 16 * MT - 1) &&\n'
        '        !(kt == n_k_tiles / 2 && q0 >= p.T - 512)) {\n'),
    # each row also sees the key after it
    'causal_mask_lets_next_key_in': (
        _MASK, _MASK.replace('kc > qr', 'kc > qr + 1')),
    # each row loses its own key
    'causal_mask_hides_the_diagonal': (
        _MASK, _MASK.replace('kc > qr', 'kc >= qr')),
}

BACKWARD_KERNEL = 'flash_attention_bwd'
_DQ_MASK = 'if (kc >= p.T || (p.causal && kc > rows[e / 2]))'
_DKV_MASK = 'if (qc >= p.T || (p.causal && key > qc))'
_DQ_A = '        uint32_t a[BLOCK_N / 16][4];\n'
_DQ_PACK = ('          a[kk][3] = Mma<T>::pack(sc[8 * kk + 6], '
            'sc[8 * kk + 7]);\n')
_DQ_WGMMA = ('          Wgmma<T, D>::template rs<1>(dq, a[kk], '
             'Tl::mn_major(Kc, BLOCK_N, kk));\n')
_DV_WGMMA = 'Wgmma<T, D>::template rs<1>(dv, pa[kk],'


def _residue(j: int) -> str:
    """The part of dS element sc[8 kk + j] that rounding to T drops."""
    return f'sc[8 * kk + {j}] - float(T(sc[8 * kk + {j}]))'


#: name -> [(text of the backward kernels' source, its replacement), ...]
BACKWARD_FAULTS = {
    # keys in the last 512 lose their block's second q-tile
    'dkv_q_tile_skipped_in_last_512_keys': [(
        _DKV_MASK,
        _DKV_MASK[:-1] + ' || (qt == first_qt + 1 && k0 >= p.T - 512))')],
    # dq: each query also takes a gradient from the key after it
    'dq_causal_mask_lets_next_key_in': [(
        _DQ_MASK, _DQ_MASK.replace('rows[e / 2]', 'rows[e / 2] + 1'))],
    # dk/dv: each key loses its own query
    'dkv_causal_mask_hides_the_diagonal': [(
        _DKV_MASK, _DKV_MASK.replace('> qc', '>= qc'))],
    # dq: dS not rounded to the input dtype before dS K (its rounding
    # residue goes through a second product)
    'dq_ds_not_rounded': [
        (_DQ_A, '        uint32_t a[BLOCK_N / 16][4], lo[BLOCK_N / 16][4];\n'),
        (_DQ_PACK, _DQ_PACK + ''.join(
            f'          lo[kk][{j}] = Mma<T>::pack({_residue(2 * j)}, '
            f'{_residue(2 * j + 1)});\n' for j in range(4))),
        (_DQ_WGMMA, _DQ_WGMMA + _DQ_WGMMA.replace('a[kk]', 'lo[kk]'))],
    # dk/dv: the lse multiplied by the scale once more
    'dkv_lse_off_by_the_scale': [(
        '-lse_c[qi] * LOG2E', '-lse_c[qi] * LOG2E * p.scale')],
    # dv: wgmma's transpose bit dropped, with a K-major descriptor over
    # the same dO tile (in bounds at D = 64), so dV = P^T dO^T
    'dv_transpose_bit_dropped': [(
        _DV_WGMMA + ' Tl::mn_major(dOc, BLOCK_M, kk));',
        _DV_WGMMA.replace('rs<1>', 'rs<0>')
        + ' Tl::k_major(dOc, BLOCK_M, 0, kk));')],
}


NORM_KERNEL = 'fused_norm'
_NORM_VAR = 'double var = q / p.R - d * d;'

#: name -> [(text of the fused norm kernel's source, its replacement)]
NORM_FAULTS = {
    # the statistics lose the last row block's partial sums
    'last_row_block_dropped': [(
        'b < p.row_blocks; b += FIN_B', 'b < p.row_blocks - 1; b += FIN_B')],
    # var = E[x²], the mean² term forgotten (the sums are of x - k:
    # E[x²] = E[(x-k)²] + 2k·E[x-k] + k²)
    'var_without_mean_squared': [(
        _NORM_VAR,
        'double var = q / p.R + 2.0 * shift * d + shift * shift;')],
    # the unbiased variance (torch.nn.BatchNorm2d's running one)
    'unbiased_var': [(
        _NORM_VAR,
        'double var = (q / p.R - d * d) * p.R / fmax(p.R - 1.0, 1.0);')],
    # the ReLU applied whether asked for or not
    'relu_when_act_false': [(
        'if (p.act) v = fmaxf(v, 0.f);', 'v = fmaxf(v, 0.f);')],
    # gamma and beta swapped
    'gamma_beta_swapped': [(
        'Params p{x, y, gamma, beta,', 'Params p{x, y, beta, gamma,')],
}


GEMM_HEADER = 'int8_gemm.cuh'
_DROP_K_TILE = (
    GEMM_HEADER, '      const int st = kt % STAGES;\n',
    '      if (kt == n_k / 2) continue;\n      const int st = kt % STAGES;\n')

INT8_KERNEL = 'int8_matmul'
#: name -> [(text of the int8 matmul's source, its replacement), or
#: (header, text, replacement)]
INT8_FAULTS = {
    # the middle K tile of every tile product skipped
    'k_tile_dropped': [_DROP_K_TILE],
    # the unsplit epilogue scales each column by its neighbour's scale
    'scale_of_next_channel': [(
        'const float s0 = col < p.N ? p.scale[col] : 0.f;',
        'const float s0 = col + 1 < p.N ? p.scale[col + 1] : 0.f;')],
    # the split-K sum scales by the neighbour's scale
    'split_sum_scale_of_next_channel': [(
        'p.out[i] = s * p.scale[n];',
        'p.out[i] = s * p.scale[n + 1 < p.N ? n + 1 : n];')],
    # the tiles' rows past M are stored
    'unmasked_m_tail_store': [(GEMM_HEADER, '  if (row >= M) return;\n', '')],
    # the columns past N of a tile's last pair are stored
    'unmasked_n_tail_store': [(
        GEMM_HEADER,
        '  if (col < N) p[0] = v0;\n  if (col + 1 < N) p[1] = v1;',
        '  p[0] = v0;\n  p[1] = v1;')],
    # the scalar path reads 8 columns past the end of its K range
    'k_tail_read_past_k': [
        (GEMM_HEADER, 'xs[r * LDX + kc] = row < M && col < kend',
         'xs[r * LDX + kc] = row < M && col < kend + 8'),
        (GEMM_HEADER, 'ws[r * LDW + kc] = n < N && col < kend',
         'ws[r * LDW + kc] = n < N && col < kend + 8')],
}

STACK_KERNEL = 'serving_stack'
#: name -> edits, as INT8_FAULTS
STACK_FAULTS = {
    'k_tile_dropped': [_DROP_K_TILE],
    # each block normalises by its own max, not the grid's
    'feed_max_of_own_block': [(
        'g = fmaxf(g, __ldcg(p.slots + i));',
        'g = fmaxf(g, __ldcg(p.slots + blockIdx.x));')],
    # the feed passes y through unnormalised
    'feed_skipped': [(
        '__float2bfloat16_rn(p.feed ? y / denom : y)',
        '__float2bfloat16_rn(y)')],
    # each column scaled by its neighbour's scale
    'scale_of_next_channel': [(
        'v0 *= col < N ? s[col] : 0.f;',
        'v0 *= col + 1 < N ? s[col + 1] : 0.f;')],
}


CE_KERNEL = 'fused_ce'
#: name -> edits of the CE kernels' source, as INT8_FAULTS
CE_FAULTS = {
    # the backward's p without its z-loss factor 1 + 2z·lse
    'z_term_dropped_from_backward': [(
        'const float c1 = 1.f + p.two_z * lse;', 'const float c1 = 1.f;')],
    # ε/V with V rounded up to a multiple of 128 (the TPU's vocab tile)
    'smoothing_over_rounded_up_v': [(
        'p.eps_per_v = static_cast<float>(eps / V);',
        'p.eps_per_v = static_cast<float>(eps / ((V + 127) / 128 * 128));')],
    # the last partial vector of a row read (and, backward, written) in
    # full: up to 7 values past the row
    'v_tail_unmasked': [(
        's.nvec = (V - s.head) / VEC;',
        's.nvec = (V - s.head + VEC - 1) / VEC;')],
    # the label's logit read one to the right
    'label_pick_off_by_one': [(
        'const float picked = to_f(xr[lab]);',
        'const float picked = to_f(xr[min(lab + 1, p.V - 1)]);')],
    # a thread's running sum not rescaled when its max grows
    'max_correction_skipped': [(
        's *= exp2f((m - cm) * LOG2E);  // rescale the sum to the new max',
        '// (no rescale)')],
}


def build_faults(out_dir: str, kernel: str, faults: dict,
                 logs: dict = None) -> dict:
    """{fault: library path} for ``faults`` ({name: [(old, new), ...]})
    planted in ``csrc/<kernel>.cu`` — or, for an edit ``(header, old,
    new)``, in a copy of that ``csrc/`` header beside the fault's source,
    where its ``#include "..."`` finds it first — one nvcc per fault, all
    started together. ``logs``, if given, receives each build's output
    (ptxas's report)."""
    src = os.path.join(_build.CSRC_DIR, kernel + '.cu')
    running = {}
    for name, edits in faults.items():
        texts = {}
        for edit in edits:
            file, old, new = edit if len(edit) == 3 else (
                kernel + '.cu', *edit)
            if file not in texts:
                with open(os.path.join(_build.CSRC_DIR, file)) as fh:
                    texts[file] = fh.read()
            if texts[file].count(old) != 1:
                raise RuntimeError(
                    f'fault {name}: the text it edits is not in {file} once')
            texts[file] = texts[file].replace(old, new)
        fault_dir = os.path.join(out_dir, kernel, name)
        os.makedirs(fault_dir)
        with open(src) as fh:
            texts.setdefault(kernel + '.cu', fh.read())
        for file, text in texts.items():
            with open(os.path.join(fault_dir, file), 'w') as fh:
                fh.write(text)
        cu = os.path.join(fault_dir, kernel + '.cu')
        so = os.path.join(fault_dir, f'{name}.so')
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, '-I', _build.CSRC_DIR,
               '-o', so, cu]
        running[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    built = {}
    for name, (proc, so) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'fault {name} did not build:\n{log}')
        if logs is not None:
            logs[name] = log
        built[name] = so
    return built


def scaled_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max of |out - ref| / (1 + |ref|): an elementwise bound scaled to
    the tensor's size, shown beside the row error for comparison."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (1 + ref.abs())).max())


def check(shape, seed: int) -> tuple:
    """(row error, scaled error) of the loaded forward kernel at
    ``shape``."""
    b, t, h, d, dtype, causal = shape
    gen = torch.Generator(device='cuda').manual_seed(seed)
    q, k, v = qkv_views(b, t, h, d, dtype, gen)
    out = fa.flash_attention_forward(q, k, v, causal=causal)
    ref = fa.reference_attention(q, k, v, causal=causal, round_p=True)
    return row_relative_error(out, ref), scaled_error(out, ref)


def _fmt(errors: dict) -> str:
    return ','.join(f'{n}:{e:.3e}' for n, e in errors.items())


def check_backward(shape, seed: int) -> dict:
    gen = torch.Generator(device='cuda').manual_seed(seed)
    result = backward_check(shape, gen)
    torch.cuda.empty_cache()
    return result


def check_norm(shape, seed: int) -> dict:
    gen = torch.Generator(device='cuda').manual_seed(seed)
    result = norm_check(shape, gen)
    torch.cuda.empty_cache()
    return result


def _norm_line(r: dict) -> str:
    return (f'mean_err={r["mean_err"]:.3e} var_err={r["var_err"]:.3e} '
            f'tol={NORM_STAT_TOL} y_err={r["y_err"]:.3e}')


def check_int8(shape, seed: int) -> dict:
    gen = torch.Generator(device='cuda').manual_seed(seed)
    result = int8_check(shape, gen)
    torch.cuda.empty_cache()
    return result


def check_stack(shape, seed: int) -> dict:
    gen = torch.Generator(device='cuda').manual_seed(seed)
    result = stack_check(shape, gen)
    torch.cuda.empty_cache()
    return result


def check_ce(shape, seed: int) -> dict:
    gen = torch.Generator(device='cuda').manual_seed(seed)
    result = ce_check(shape, gen)
    torch.cuda.empty_cache()
    return result


def _ce_line(r: dict, dtype) -> str:
    return (f'loss_err={r["loss_err"]:.3e} lse_err={r["lse_err"]:.3e} '
            f'tol={CE_LOSS_TOL} dx_row_err={r["dx_row_err"]:.3e} '
            f'tol={CE_ROW_TOL[dtype]} canary={r["canary"]} '
            f'finite={r["finite"]}')


def _int8_line(r: dict) -> str:
    return (f'row_err={r["row_err"]:.3e} tol={INT8_ROW_TOL} '
            f'canary={r["canary"]} finite={r["finite"]}')


def _failing(shapes, check, ok, seed: int) -> list:
    """[(shape, result)] of the shapes at which ``check`` fails ``ok``."""
    return [(shape, r) for shape in shapes for r in [check(shape, seed)]
            if not ok(r, shape)]


def _with_library(kernel: str, so: str, fn):
    """``fn()`` with the kernel library swapped for the one at ``so``."""
    shipped = _build.library(kernel)
    _build._LIBS[kernel] = ctypes.CDLL(so)
    try:
        return fn()
    finally:
        _build._LIBS[kernel] = shipped


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('FAIL: no CUDA card', flush=True)
        return 1
    holes = 0
    for shape in ATTENTION_SHAPES:
        tol = ATTENTION_ROW_TOL[shape[4]]
        for seed in args.seeds:
            row, scaled = check(shape, seed)
            holes += not row <= tol
            print(f'[kernel] shape={shape[:4]} dtype={str(shape[4])[6:]} '
                  f'causal={shape[5]} seed={seed} row_err={row:.3e} '
                  f'tol={tol} scaled_err={scaled:.3e} '
                  f'ok={row <= tol}', flush=True)
        torch.cuda.empty_cache()
    for shape in BACKWARD_SHAPES:
        for seed in args.seeds:
            r = check_backward(shape, seed)
            ok = backward_ok(r, shape[4])
            holes += not ok
            print(f'[backward] shape={shape[:4]} dtype={str(shape[4])[6:]} '
                  f'causal={shape[5]} seed={seed} lse_err={r["lse_err"]:.3e} '
                  f'row_err={_fmt(r["row_err"])} '
                  f'tol={BACKWARD_ROW_TOL[shape[4]]} '
                  f'head_err={_fmt(r["head_err"])} '
                  f'tol={BACKWARD_HEAD_TOL[shape[4]]} '
                  f'autograd_head_err={_fmt(r["autograd_head_err"])} '
                  f'autograd_row_err={_fmt(r["autograd_row_err"])} '
                  f'ok={ok}', flush=True)

    for shape in NORM_SHAPES:
        for seed in args.seeds:
            r = check_norm(shape, seed)
            ok = norm_ok(r, shape[2])
            holes += not ok
            print(f'[norm] shape={shape[:2]} dtype={str(shape[2])[6:]} '
                  f'act={shape[3]} seed={seed} {_norm_line(r)} '
                  f'tol={NORM_Y_TOL[shape[2]]} ok={ok}', flush=True)

    for shape in INT8_SHAPES:
        for seed in args.seeds:
            r = check_int8(shape, seed)
            ok = int8_ok(r)
            holes += not ok
            print(f'[int8] shape={shape} seed={seed} {_int8_line(r)} '
                  f'max_abs_err={r["max_abs_err"]:.3e} ok={ok}', flush=True)
    for shape in STACK_SHAPES:
        for seed in args.seeds:
            r = check_stack(shape, seed)
            ok = stack_ok(r, shape[0])
            holes += not ok
            print(f'[stack] shape={shape[:3]} w={str(shape[3])[6:]} '
                  f'feed={shape[4]} seed={seed} row_err={r["row_err"]:.3e} '
                  f'tol={stack_tol(shape[0])} step_err={r["step_err"]:.3e} '
                  f'step_tol={STACK_ROW_TOL["step"]} ok={ok}', flush=True)

    for shape in CE_SHAPES:
        for seed in args.seeds:
            r = check_ce(shape, seed)
            ok = ce_ok(r, shape[2])
            holes += not ok
            print(f'[ce] shape={shape[:2]} dtype={str(shape[2])[6:]} '
                  f'z={shape[3]} eps={shape[4]} pad={shape[5]} seed={seed} '
                  f'{_ce_line(r, shape[2])} ok={ok}', flush=True)

    serving = ATTENTION_SHAPES[0]
    tol = ATTENTION_ROW_TOL[serving[4]]
    training = BACKWARD_SHAPES[0]
    with tempfile.TemporaryDirectory(prefix='kernel_faults_') as tmp:
        forward = build_faults(tmp, KERNEL, {
            name: [edit] for name, edit in FAULTS.items()})
        for name, so in forward.items():
            row, scaled = _with_library(
                KERNEL, so, lambda: check(serving, args.seeds[0]))
            holes += row <= tol
            print(f'[fault] {name} shape={serving[:4]} row_err={row:.3e} '
                  f'tol={tol} caught={not row <= tol} '
                  f'scaled_err={scaled:.3e}', flush=True)
        backward = build_faults(tmp, BACKWARD_KERNEL, BACKWARD_FAULTS)
        for name, so in backward.items():
            r = _with_library(BACKWARD_KERNEL, so, lambda: check_backward(
                training, args.seeds[0]))
            caught = not backward_ok(r, training[4])
            holes += not caught
            print(f'[fault] {name} shape={training[:4]} '
                  f'row_err={_fmt(r["row_err"])} '
                  f'tol={BACKWARD_ROW_TOL[training[4]]} '
                  f'head_err={_fmt(r["head_err"])} '
                  f'tol={BACKWARD_HEAD_TOL[training[4]]} '
                  f'autograd_head_err={_fmt(r["autograd_head_err"])} '
                  f'caught={caught}', flush=True)
        norm = build_faults(tmp, NORM_KERNEL, NORM_FAULTS)
        for name, so in norm.items():
            failed = _with_library(NORM_KERNEL, so, lambda: [
                (shape, r) for shape in NORM_SHAPES
                for r in [check_norm(shape, args.seeds[0])]
                if not norm_ok(r, shape[2])])
            holes += not failed
            first = failed[0] if failed else None
            print(f'[fault] {name} caught={bool(failed)} '
                  f'failing_shapes={len(failed)}/{len(NORM_SHAPES)}'
                  + (f' first={first[0][:2]} {str(first[0][2])[6:]} '
                     f'act={first[0][3]} {_norm_line(first[1])}'
                     if first else ''), flush=True)
        for kernel, faults, shapes, run, passes in (
                (INT8_KERNEL, INT8_FAULTS, INT8_SHAPES, check_int8,
                 lambda r, shape: int8_ok(r)),
                (STACK_KERNEL, STACK_FAULTS, STACK_SHAPES, check_stack,
                 lambda r, shape: stack_ok(r, shape[0]))):
            for name, so in build_faults(tmp, kernel, faults).items():
                failed = _with_library(kernel, so, lambda: _failing(
                    shapes, run, passes, args.seeds[0]))
                holes += not failed
                first = failed[0] if failed else None
                print(f'[fault] {kernel}.{name} caught={bool(failed)} '
                      f'failing_shapes={len(failed)}/{len(shapes)}'
                      + (f' first={first[0]} row_err='
                         f'{first[1]["row_err"]:.3e}'
                         + (f' canary={first[1]["canary"]}'
                            if 'canary' in first[1] else
                            f' step_err={first[1]["step_err"]:.3e}')
                         if first else ''), flush=True)
        for name, so in build_faults(tmp, CE_KERNEL, CE_FAULTS).items():
            failed = _with_library(CE_KERNEL, so, lambda: _failing(
                CE_SHAPES, check_ce, lambda r, shape: ce_ok(r, shape[2]),
                args.seeds[0]))
            holes += not failed
            first = failed[0] if failed else None
            print(f'[fault] {CE_KERNEL}.{name} caught={bool(failed)} '
                  f'failing_shapes={len(failed)}/{len(CE_SHAPES)}'
                  + (f' first={first[0][:2]} {str(first[0][2])[6:]} '
                     f'z={first[0][3]} eps={first[0][4]} '
                     f'{_ce_line(first[1], first[0][2])}'
                     if first else ''), flush=True)
    print(f'[done] holes={holes}', flush=True)
    return 1 if holes else 0


if __name__ == '__main__':
    sys.exit(main())
