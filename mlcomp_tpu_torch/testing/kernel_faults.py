"""Plant faults in copies of the kernels and read each against the
card-side check, to show the check would catch them.

    python -m mlcomp_tpu_torch.testing.kernel_faults [--seeds 0 1 2]

Needs one CUDA card and ``nvcc``. First the kernels as they stand run at
every shape of ``kernel_check.ATTENTION_SHAPES`` (forward),
``kernel_check.BACKWARD_SHAPES`` (forward with lse, then backward),
``kernel_check.NORM_SHAPES`` (fused norm, forward and backward),
``kernel_check.INT8_SHAPES``
(int8 matmul; its fused epilogue, bit for bit, at
``kernel_check.INT8_EPILOGUE_SHAPES``), ``kernel_check.STACK_SHAPES``
(serving stack) and
``kernel_check.CE_SHAPES`` (cross-entropy, forward and backward) for
each seed, which shows the margin of each tolerance. Then each fault below, a
textual edit of a kernel's ``csrc/*.cu`` (or of a header it includes,
copied beside it) written to a temporary directory (the checkout is not
touched) and built with the package's nvcc flags, runs at the serving
shape (forward faults; their lse also at the training shape), the
training shape (backward faults) or every
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
    BACKWARD_SHAPES, CE_LOSS_TOL, CE_ROW_TOL, CE_SHAPES,
    INT8_EPILOGUE_SHAPES, INT8_ROW_TOL, INT8_SHAPES, LSE_TOL, NORM_DX_TOL,
    NORM_GRAD_TOL, NORM_SHAPES, NORM_STAT_TOL, NORM_Y_TOL,
    STACK_ROW_TOL, STACK_SHAPES, backward_check, backward_ok, ce_check,
    ce_ok, forward_with_lse, int8_check, int8_epilogue_check,
    int8_epilogue_ok, int8_ok, lse_error, norm_bwd_check, norm_bwd_ok,
    norm_check, norm_ok, qkv_views, row_relative_error, stack_check, stack_ok,
    stack_tol,
)

KERNEL = 'flash_attention_fwd'
_MASK = '            if (kc >= p.T || (p.causal && kc > rows[e / 2]))\n'
#: the mask pass, from its test of the tile to its test of a score
_MASK_PASS = (
    '      if (k0 + BLOCK_N > p.T || (p.causal && k0 + BLOCK_N - 1 > '
    'wrow0)) {\n'
    '#pragma unroll\n'
    '        for (int n = 0; n < N_TILES; ++n) {\n'
    '#pragma unroll\n'
    '          for (int e = 0; e < 4; ++e) {\n'
    '            const int kc = k0 + n * 8 + tq * 2 + (e & 1);\n' + _MASK)
_PV_WGMMA = ('    Wgmma<T, D>::template rs<1>(o, pa[kk], '
             'Tl::mn_major(v, BLOCK_N, kk));\n')
_LSE_ROW = '          lg[rows[i]] = (m_r[i] + log2f(norm[i])) * LN2;\n'


def _tile_skipped(cond: str) -> tuple:
    """The edit that masks every score of a K/V tile where ``cond``
    holds (the mask pass runs there, and each score takes NEG_INF): the
    tile then adds nothing to the rows, as if it were skipped."""
    new = _MASK_PASS.replace(') {\n', f' || ({cond})) {{\n', 1)
    return _MASK_PASS, new.replace(
        '))\n', f') ||\n                ({cond}))\n')


#: name -> (text of the forward kernel's source, its faulty replacement)
FAULTS = {
    # rows from 4096 on lose keys 128..255 (tile 1): ~2% of their keys
    'k_tile_skipped_from_row_4096': _tile_skipped(
        'kt == 1 && tc.q0 >= 4096'),
    # the last 512 rows lose the middle K/V tile
    'mid_k_tile_skipped_in_last_512_rows': _tile_skipped(
        'kt == n_k / 2 && tc.q0 >= p.T - 512'),
    # each row also sees the key after it
    'causal_mask_lets_next_key_in': (
        _MASK, _MASK.replace('kc > rows[e / 2]', 'kc > rows[e / 2] + 1')),
    # each row loses its own key
    'causal_mask_hides_the_diagonal': (
        _MASK, _MASK.replace('kc > rows[e / 2]', 'kc >= rows[e / 2]')),
    # wgmma's transpose bit dropped, with a K-major descriptor over the
    # same V tile (in bounds at D = 64): O += P V^T's first D keys
    'v_transpose_bit_dropped': (
        _PV_WGMMA,
        _PV_WGMMA.replace('rs<1>', 'rs<0>').replace(
            'Tl::mn_major(v, BLOCK_N, kk)',
            'Tl::k_major(v, BLOCK_N, 0, kk % (D / 16))')),
    # the second consumer writes its rows' lse over the first's (its own
    # rows are left unwritten)
    'second_consumer_lse_rows_64_off': (
        _LSE_ROW,
        _LSE_ROW.replace('lg[rows[i]]', 'lg[rows[i] - (wg == 1 ? 64 : 0)]')),
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
#: the warp's loop over the blocks' partials (both norm kernels)
_NORM_PARTIALS = 'for (int b = lane; b < G; b += 32) {'

#: name -> [(text of the fused norm kernel's source, its replacement)]
NORM_FAULTS = {
    # the statistics lose the last block's partial sums
    'last_block_partial_dropped': [(
        _NORM_PARTIALS, 'for (int b = lane; b < G - 1; b += 32) {')],
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
        'if (act) v = fmaxf(v, 0.f);', 'v = fmaxf(v, 0.f);')],
    # gamma and beta swapped
    'gamma_beta_swapped': [(
        'Params p{x, y, gamma, beta,', 'Params p{x, y, beta, gamma,')],
    # the rows past the shared-memory budget (streamed) left out of the
    # statistics
    'streamed_rows_left_out_of_stats': [(
        'sweep<U>(rows.r0 + rows.res + ty, rows.r1, lanes,',
        'sweep<U>(rows.r1 + ty, rows.r1, lanes,')],
    # the normalize pass applies each block's resident tile to the next
    # block's rows
    'resident_tile_applied_to_the_next_block': [(
        'apply(rows.r0 + rr, raw);', 'apply((rows.r1 + rr) % p.R, raw);')],
}

NORM_BWD_KERNEL = 'fused_norm_bwd'
_BWD_PRE = 'const float pre = fmaf(xh[i], ch[GAMMA][i], ch[BETA][i]);'

#: name -> [(text of the norm backward kernel's source, its replacement)]
NORM_BWD_FAULTS = {
    # dy passed through where the ReLU was off
    'mask_dropped': [(
        'if (!(pre > 0.f)) d[i] = 0.f;', '(void)pre;')],
    # the mask from the sign of y without beta: xhat·gamma > 0
    'mask_without_beta': [(
        _BWD_PRE, 'const float pre = xh[i] * ch[GAMMA][i];')],
    # dx without its -dbeta/R term
    'dbeta_over_r_dropped': [(
        'd[i] = (fmaf(xh[i], ch[A][i], d[i]) - ch[B][i]) * sc[i];',
        'd[i] = fmaf(xh[i], ch[A][i], d[i]) * sc[i];')],
    # the sums lose the last block's partials
    'last_block_partial_dropped': [(
        _NORM_PARTIALS, 'for (int b = lane; b < G - 1; b += 32) {')],
    # dgamma summed over x instead of xhat
    'dgamma_over_x': [(
        'q[i] = fmaf(d[i], xh[i], q[i]);', 'q[i] = fmaf(d[i], xv[i], q[i]);')],
    # dx scaled by inv alone, gamma missing
    'gamma_missing_from_dx_scale': [(
        'sc[i] = ch[INV][i] * ch[GAMMA][i];', 'sc[i] = ch[INV][i];')],
}


GEMM_HEADER = 'int8_gemm.cuh'
#: the weight fragment's two K halves swapped (k 2t.. and 2t + 8..), the
#: products then pair each weight with the wrong x column
_K_PAIR_SWAPPED = [
    (GEMM_HEADER, '  a[0] = b_pair(tile + at);\n',
     '  a[0] = b_pair(tile + at + 8);\n'),
    (GEMM_HEADER, '  a[2] = b_pair(tile + at + 8);\n',
     '  a[2] = b_pair(tile + at);\n')]

INT8_KERNEL = 'int8_matmul'
_STORE_SCALE = '    y[j] = __fmul_rn(v[j], p.scale[n]);\n'
#: name -> [(text of the int8 matmul's source, its replacement), or
#: (header, text, replacement)]
INT8_FAULTS = {
    # the middle K tile of every block's range skipped (its stage still
    # released)
    'k_tile_dropped': [(
        '    mbar_wait(&full[s], (i / C::STAGES) & 1);\n',
        '    mbar_wait(&full[s], (i / C::STAGES) & 1);\n'
        '    if (i == n_k / 2) {\n      mbar_arrive(&empty[s]);\n'
        '      continue;\n    }\n')],
    # the epilogue (and the split-K sum) scales each column by its
    # neighbour's scale
    'scale_of_next_channel': [(
        _STORE_SCALE,
        _STORE_SCALE.replace('p.scale[n]', 'p.scale[n + 1 < p.N ? n + 1 : n]'))],
    # the split-K sum drops the last split
    'split_sum_drops_last_split': [(
        'for (int j = 0; j < p.splits; ++j) {',
        'for (int j = 0; j < p.splits - 1; ++j) {')],
    # the transposed store writes the tile's rows past M
    'unmasked_m_tail_store': [(
        'r < C::BN && m0 + r < p.M; r += STEP',
        'r < C::BN; r += STEP')],
    # the last 4-column group of a row is stored whole past N
    'unmasked_n_tail_store': [(
        '      if (c + j < p.N) o[j] = y[j];', '      o[j] = y[j];')],
    'weight_fragment_k_pair_swapped': _K_PAIR_SWAPPED,
    # the consumers read the next ring stage, not the one they waited for
    'stage_index_off_by_one': [(
        '    const unsigned char* xs = ring + s * C::STAGE_BYTES;',
        '    const unsigned char* xs =\n'
        '        ring + ((i + 1) % C::STAGES) * C::STAGE_BYTES;')],
    # the bias added by a fused multiply-add (one rounding, not two):
    # the bf16 / fp16 epilogue is no longer the unfused formula's bits
    'bias_by_contracted_fma': [(
        '    if (p.bias != nullptr) y[j] = __fadd_rn(y[j], p.bias[n]);',
        '    if (p.bias != nullptr)\n'
        '      y[j] = __fmaf_rn(v[j], p.scale[n], p.bias[n]);')],
}

STACK_KERNEL = 'serving_stack'
#: name -> edits, as INT8_FAULTS
STACK_FAULTS = {
    # the middle K tile of each rank's slice skipped (its stage still
    # released)
    'k_tile_dropped': [(
        '            if (k0 + kt * R::W_BK < p.K)\n',
        '            if (k0 + kt * R::W_BK < p.K && kt != k_tiles / 2)\n')],
    # each block normalises by its own max, not the grid's
    'feed_max_of_own_block': [(
        'gm = fmaxf(gm, __ldcg(slots + i));',
        'gm = fmaxf(gm, __ldcg(slots + blockIdx.x));')],
    # the feed passes y through unnormalised
    'feed_skipped': [('        if (p.feed) {\n', '        if (false) {\n')],
    # each column scaled by its neighbour's scale
    'scale_of_next_channel': [(
        'v[e] = __fmul_rn(v[e], s_l[n + e]);',
        'v[e] = __fmul_rn(v[e], s_l[n + e + 1 < N ? n + e + 1 : n + e]);')],
    # the cluster's sum leaves out the last rank's partial
    'cluster_partial_dropped': [(
        's4[q] = load_cluster(part + tok * LDP + c, h + q);',
        's4[q] = h + q == CS - 1 ? make_float4(0.f, 0.f, 0.f, 0.f)\n'
        '                                 : load_cluster(part + tok * LDP + c,'
        ' h + q);')],
    # every rank's turn reads this CTA's own partial
    'cluster_partial_of_own_rank': [(
        'load_cluster(part + tok * LDP + c, h + q);',
        'load_cluster(part + tok * LDP + c, rank);')],
    # the int8 product reads the stage's first x column block twice
    'x_column_block_repeated': [(
        'k_major_desc(xt + (kk / 4) * (MT * 128), 0, kk % 4)',
        'k_major_desc(xt, 0, kk % 4)')],
    # between layers the last rank of each cluster feeds none of its
    # shares of y (those columns of the next x keep the last layer's)
    'feed_of_last_rank_dropped': [(
        '        if (m >= p.M || n >= N) continue;',
        '        if (m >= p.M || n >= N || rank == CS - 1) continue;')],
    'weight_fragment_k_pair_swapped': _K_PAIR_SWAPPED,
    # the consumers read the next ring stage, not the one they waited for
    'stage_index_off_by_one': [(
        'stage_product(acc, ring + s * R::STAGE,',
        'stage_product(acc, ring + ((it + 1) % R::STAGES) * R::STAGE,')],
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


def check_lse(shape, seed: int) -> float:
    """The lse error of the loaded forward kernel at ``shape``, as
    ``backward_check`` (the smoke's check) takes it: through
    ``forward_with_lse``, so a row the kernel does not write fails."""
    b, t, h, d, dtype, causal = shape
    gen = torch.Generator(device='cuda').manual_seed(seed)
    q, k, v = qkv_views(b, t, h, d, dtype, gen)
    _, lse = forward_with_lse(q, k, v, causal)
    _, ref = fa.reference_attention(q, k, v, causal=causal, with_lse=True)
    err = lse_error(lse, ref)
    del q, k, v, lse, ref
    torch.cuda.empty_cache()
    return err


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


def check_norm_bwd(shape, seed: int) -> dict:
    gen = torch.Generator(device='cuda').manual_seed(seed)
    result = norm_bwd_check(shape, gen)
    torch.cuda.empty_cache()
    return result


def _norm_bwd_line(r: dict, dtype) -> str:
    return (f'dx_err={r["dx_err"]:.3e} tol={NORM_DX_TOL[dtype]} '
            f'dgamma_err={r["dgamma_err"]:.3e} dbeta_err={r["dbeta_err"]:.3e} '
            f'tol={NORM_GRAD_TOL} band={r["band"]} flips={r["flips"]} '
            f'flips_outside_band={r["flips_outside_band"]} '
            f'finite={r["finite"]}')


#: what the int8 faults run against: every INT8_SHAPES shape, then the
#: fused epilogue at each INT8_EPILOGUE_SHAPES shape
INT8_CHECKS = list(INT8_SHAPES) + [('epilogue', s)
                                   for s in INT8_EPILOGUE_SHAPES]


def check_int8(shape, seed: int) -> dict:
    """``int8_check`` at an (M, K, N), or ``int8_epilogue_check`` at an
    ('epilogue', (M, K, N))."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    if shape[0] == 'epilogue':
        result = int8_epilogue_check(shape[1], gen)
    else:
        result = int8_check(shape, gen)
    torch.cuda.empty_cache()
    return result


def int8_passes(result: dict, shape) -> bool:
    return int8_epilogue_ok(result) if shape[0] == 'epilogue' \
        else int8_ok(result)


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


def _fault_result(r: dict) -> str:
    """An int8, epilogue or stack check's result, shortened."""
    if 'row_err' not in r:
        return f'differing_elements={r}'
    return f'row_err={r["row_err"]:.3e}' + (
        f' canary={r["canary"]}' if 'canary' in r
        else f' step_err={r["step_err"]:.3e}')


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
            r = check_norm_bwd(shape, seed)
            ok = norm_bwd_ok(r, shape)
            holes += not ok
            print(f'[norm-bwd] shape={shape[:2]} dtype={str(shape[2])[6:]} '
                  f'act={shape[3]} seed={seed} '
                  f'{_norm_bwd_line(r, shape[2])} ok={ok}', flush=True)

    for shape in INT8_SHAPES:
        for seed in args.seeds:
            r = check_int8(shape, seed)
            ok = int8_ok(r)
            holes += not ok
            print(f'[int8] shape={shape} seed={seed} {_int8_line(r)} '
                  f'max_abs_err={r["max_abs_err"]:.3e} ok={ok}', flush=True)
    for shape in INT8_EPILOGUE_SHAPES:
        for seed in args.seeds:
            r = check_int8(('epilogue', shape), seed)
            ok = int8_epilogue_ok(r)
            holes += not ok
            print(f'[int8-epilogue] shape={shape} seed={seed} '
                  f'differing_elements={r} ok={ok}', flush=True)
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
            row, scaled, lse_err = _with_library(KERNEL, so, lambda: (
                *check(serving, args.seeds[0]),
                check_lse(training, args.seeds[0])))
            caught = not (row <= tol and lse_err <= LSE_TOL)
            holes += not caught
            print(f'[fault] {name} shape={serving[:4]} row_err={row:.3e} '
                  f'tol={tol} lse_shape={training[:4]} '
                  f'lse_err={lse_err:.3e} lse_tol={LSE_TOL} '
                  f'caught={caught} scaled_err={scaled:.3e}', flush=True)
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
        for name, so in build_faults(tmp, NORM_BWD_KERNEL,
                                     NORM_BWD_FAULTS).items():
            failed = _with_library(NORM_BWD_KERNEL, so, lambda: _failing(
                NORM_SHAPES, check_norm_bwd, norm_bwd_ok, args.seeds[0]))
            holes += not failed
            first = failed[0] if failed else None
            print(f'[fault] {NORM_BWD_KERNEL}.{name} caught={bool(failed)} '
                  f'failing_shapes={len(failed)}/{len(NORM_SHAPES)}'
                  + (f' first={first[0][:2]} {str(first[0][2])[6:]} '
                     f'act={first[0][3]} '
                     f'{_norm_bwd_line(first[1], first[0][2])}'
                     if first else ''), flush=True)
        for kernel, faults, shapes, run, passes in (
                (INT8_KERNEL, INT8_FAULTS, INT8_CHECKS, check_int8,
                 int8_passes),
                (STACK_KERNEL, STACK_FAULTS, STACK_SHAPES, check_stack,
                 lambda r, shape: stack_ok(r, shape[0]))):
            for name, so in build_faults(tmp, kernel, faults).items():
                failed = _with_library(kernel, so, lambda: _failing(
                    shapes, run, passes, args.seeds[0]))
                holes += not failed
                first = failed[0] if failed else None
                print(f'[fault] {kernel}.{name} caught={bool(failed)} '
                      f'failing_shapes={len(failed)}/{len(shapes)}'
                      + (f' first={first[0]} {_fault_result(first[1])}'
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
