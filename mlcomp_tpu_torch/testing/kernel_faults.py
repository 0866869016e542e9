"""Plant faults in a copy of the flash-attention kernel and read each
against the card-side check, to show the check would catch them.

    python -m mlcomp_tpu_torch.testing.kernel_faults [--seeds 0 1 2]

Needs one CUDA card and ``nvcc``. First the kernel as it stands runs at
every shape of ``kernel_check.ATTENTION_SHAPES`` for each seed, which
shows the margin of its tolerance. Then each fault below, a textual edit
of ``csrc/flash_attention_fwd.cu`` written to a temporary directory (the
checkout is not touched) and built with the package's nvcc flags, runs
at the serving shape. Each line gives the largest relative row error
against its bound and, for comparison, the elementwise error scaled to
``1 + |ref|``. Exits 1 if the kernel as it stands fails its bound or a
planted fault passes it.
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
    ATTENTION_ROW_TOL, ATTENTION_SHAPES, qkv_views, row_relative_error,
)

KERNEL = 'flash_attention_fwd'
_LIVE_TILE = '    if (!p.causal || k0 <= wrow0 + 16 * MT - 1) {\n'
_MASK = 'if (kc >= p.T || (p.causal && kc > qr)) s[mt][n][e] = NEG_INF;'

#: name -> (text of the kernel source, its faulty replacement)
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


def build_faults(out_dir: str) -> dict:
    """{fault: library path}, one nvcc per fault, all started together."""
    src = os.path.join(_build.CSRC_DIR, KERNEL + '.cu')
    with open(src) as fh:
        source = fh.read()
    running = {}
    for name, (old, new) in FAULTS.items():
        if source.count(old) != 1:
            raise RuntimeError(
                f'fault {name}: the text it edits is not in {src} once')
        cu = os.path.join(out_dir, f'{name}.cu')
        with open(cu, 'w') as fh:
            fh.write(source.replace(old, new))
        so = os.path.join(out_dir, f'{name}.so')
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
        built[name] = so
    return built


def scaled_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max of |out - ref| / (1 + |ref|): an elementwise bound scaled to
    the tensor's size, shown beside the row error for comparison."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (1 + ref.abs())).max())


def check(shape, seed: int) -> tuple:
    """(row error, scaled error) of the loaded kernel at ``shape``."""
    b, t, h, d, dtype, causal = shape
    gen = torch.Generator(device='cuda').manual_seed(seed)
    q, k, v = qkv_views(b, t, h, d, dtype, gen)
    out = fa.flash_attention_forward(q, k, v, causal=causal)
    ref = fa.reference_attention(q, k, v, causal=causal, round_p=True)
    return row_relative_error(out, ref), scaled_error(out, ref)


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

    serving = ATTENTION_SHAPES[0]
    tol = ATTENTION_ROW_TOL[serving[4]]
    shipped = _build.library(KERNEL)
    with tempfile.TemporaryDirectory(prefix='kernel_faults_') as tmp:
        for name, so in build_faults(tmp).items():
            _build._LIBS[KERNEL] = ctypes.CDLL(so)
            try:
                row, scaled = check(serving, args.seeds[0])
            finally:
                _build._LIBS[KERNEL] = shipped
            holes += row <= tol
            print(f'[fault] {name} shape={serving[:4]} row_err={row:.3e} '
                  f'tol={tol} caught={not row <= tol} '
                  f'scaled_err={scaled:.3e}', flush=True)
    print(f'[done] holes={holes}', flush=True)
    return 1 if holes else 0


if __name__ == '__main__':
    sys.exit(main())
