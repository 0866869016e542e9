#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mlcomp_tpu_torch``) on one
NVIDIA card — the quickest proof that the port still builds, is right
and serves on the GPU.

    python3 chip_smoke.py [--seed N]

It imports nothing of JAX or of the JAX package ``mlcomp_tpu``. Phases,
one line of output each (or more), any failure exits non-zero before the
last line:

1. device: the card's name and power limit (``nvidia-smi``), torch, CUDA
   and nvcc versions;
2. build: every kernel under ``mlcomp_tpu_torch/csrc/`` with nvcc, timed,
   with ptxas's register / spill report;
3. kernels: each kernel's wrapper on tensors on the card against its
   plain PyTorch version at several shapes (the serving path's shape
   first), by the largest relative error of an output row (see
   ``mlcomp_tpu_torch/testing/kernel_check.py``), with its time, the
   plain version's time, one PyTorch library call's time as a
   yardstick, and the least time the card could take (bytes over
   3.35 TB/s or operations over the dtype's peak);
4. serving: the flagship transformer LM (vocab 32768, d_model 1024, 16
   heads, d_ff 4096, 8 layers, T=8192, bf16 activations, f32 params;
   weights from a seed) exported with the port's ``export_model``,
   served by ``ModelServer(device='cuda')`` and asked over HTTP; the
   launch counts are zeroed just before the requests and read just
   after, and one row's logits are held against the same model with the
   plain attention;
5. the ``{"kernels": [...]}`` line, the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Without CUDA, or in a directory that holds this script and nothing else
of the repository, it exits non-zero and prints no result.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

#: published peaks of one H100 SXM (dense, no sparsity) at 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                  torch.float32: 67e12}
#: served LM vs the same weights with plain attention: cosine similarity
#: of the [T, V] logits, and top-1 agreement where a pick counts when its
#: reference logit is within TIE_DELTA (two bf16 ulps at logits of 4-8)
#: of the reference maximum — bf16 logits of random weights tie often
MIN_COSINE = 0.999
MIN_TOP1 = 0.99
TIE_DELTA = 0.0625

FLAGSHIP = {'name': 'transformer_lm', 'vocab_size': 32768, 'd_model': 1024,
            'n_layers': 8, 'n_heads': 16, 'd_ff': 4096, 'max_seq_len': 8192,
            'dtype': 'bfloat16'}
SERVE_BATCH = 4
REQUEST_ROWS = (1, 4, 2, 3) * 3


def fail(msg: str):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def say(phase: str, **fields):
    print(f'[{phase}] ' + ' '.join(f'{k}={v}' for k, v in fields.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
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


# ------------------------------------------------------------- phase 1-2
def phase_device():
    smi = nvidia_smi_line()
    nvcc_v = 'not found'
    from mlcomp_tpu_torch.ops import _build
    try:
        out = subprocess.run([_build.nvcc(), '--version'],
                             capture_output=True, text=True, timeout=60)
        nvcc_v = out.stdout.strip().splitlines()[-1]
    except RuntimeError as e:
        fail(str(e))
    say('device', card=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc_v),
        python=sys.version.split()[0])
    return smi


def phase_build():
    from mlcomp_tpu_torch.ops import _build
    t0 = time.monotonic()
    try:
        libs = _build.build()
    except RuntimeError as e:
        fail(str(e))
    seconds = time.monotonic() - t0
    for name, path in libs.items():
        log = _build.BUILD_LOGS.get(name, {}).get('log', '(cached)')
        lines = [ln.split('ptxas info    : ')[-1] for ln in log.splitlines()
                 if 'registers' in ln or 'spill' in ln]
        say('build', kernel=name, seconds=f'{seconds:.1f}',
            library=os.path.relpath(path, HERE))
        for ln in lines:
            print(f'    ptxas: {ln}', flush=True)
    return libs


# ---------------------------------------------------------------- phase 3
def attention_bound_ms(b, t, h, d, dtype, causal):
    """Least time for the work: every q·k pair the mask leaves live, two
    multiply-adds per element of D for QKᵀ and PV; each of q, k, v read
    once and out written once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    ops = 4 * b * h * d * pairs
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * t * h * d * size
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def phase_kernels(seed: int):
    from mlcomp_tpu_torch.ops.flash_attention import (
        flash_attention_forward, reference_attention,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        ATTENTION_ROW_TOL, ATTENTION_SHAPES, qkv_views, row_relative_error,
    )
    import torch.nn.functional as F
    gen = torch.Generator(device='cuda').manual_seed(seed)
    main = None
    # the serving shape first, and only it timed
    for i, (b, t, h, d, dtype, causal) in enumerate(ATTENTION_SHAPES):
        timed = i == 0
        q, k, v = qkv_views(b, t, h, d, dtype, gen)
        try:
            out = flash_attention_forward(q, k, v, causal=causal)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'flash_attention_fwd at B={b} T={t} H={h} D={d} '
                 f'{dtype} causal={causal}: {e}')
        ref = reference_attention(q, k, v, causal=causal, round_p=True)
        err = float((out.float() - ref.float()).abs().max())
        row_err = row_relative_error(out, ref)
        tol = ATTENTION_ROW_TOL[dtype]
        ok = bool(torch.isfinite(out).all()) and row_err <= tol
        fields = dict(shape=f'{b}x{t}x{h}x{d}', dtype=str(dtype)[6:],
                      causal=causal, row_err=f'{row_err:.3e}', tol=tol,
                      max_abs_err=f'{err:.3e}')
        if timed:
            bound, bound_by = attention_bound_ms(b, t, h, d, dtype, causal)
            ms = time_ms(lambda: flash_attention_forward(
                q, k, v, causal=causal), iters=20)
            plain_ms = time_ms(lambda: reference_attention(
                q, k, v, causal=causal, round_p=True), iters=3)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters=20)
            fields.update(ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.3f}',
                          library_ms=f'{library_ms:.4f}',
                          bound_ms=f'{bound:.4f}', bound_by=bound_by)
            main = {'name': 'flash_attention_fwd', 'route': 'cuda',
                    'source': 'mlcomp_tpu_torch/csrc/flash_attention_fwd.cu',
                    'replaces': 'mlcomp_tpu/ops/flash_attention.py:83',
                    'max_abs_err': err, 'row_err': row_err,
                    'ms': ms, 'plain_ms': plain_ms,
                    'bound_ms': bound, 'bound_by': bound_by,
                    'library_ms': library_ms,
                    'shape': [b, t, h, d], 'dtype': str(dtype)[6:],
                    'causal': causal}
        say('kernel', ok=ok, **fields)
        if not ok:
            fail(f'flash_attention_fwd disagrees with reference_attention '
                 f'at {fields}')
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------- phase 4
def flagship_params(seed: int) -> dict:
    """The flagship LM's weights in the JAX parameter layout (stacked
    ``layers``), from a seed: normal(0.02) embeddings, lecun-normal
    projections, unit norm scales — f32, as the JAX trainer keeps them."""
    rng = np.random.default_rng(seed)
    cfg = FLAGSHIP
    v, m, n_l = cfg['vocab_size'], cfg['d_model'], cfg['n_layers']
    h, f, s = cfg['n_heads'], cfg['d_ff'], cfg['max_seq_len']
    d = m // h

    def normal(shape, std):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(std)
        return x

    return {
        'embed': normal((v, m), 0.02),
        'pos_embed': normal((s, m), 0.02),
        'layers': {
            'norm_attn': {'scale': np.ones((n_l, m), np.float32)},
            'attn': {'qkv': {'kernel': normal((n_l, m, 3, h, d), m ** -0.5)},
                     'out': {'kernel': normal((n_l, h, d, m),
                                              (h * d) ** -0.5)}},
            'norm_mlp': {'scale': np.ones((n_l, m), np.float32)},
            'mlp': {'wi_gate': {'kernel': normal((n_l, m, f), m ** -0.5)},
                    'wi_up': {'kernel': normal((n_l, m, f), m ** -0.5)},
                    'wo': {'kernel': normal((n_l, f, m), f ** -0.5)}}},
        'norm_final': {'scale': np.ones((m,), np.float32)},
        'lm_head': {'kernel': normal((m, v), m ** -0.5)},
    }


def _http(port, path, body=None, token=None):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}',
        data=None if body is None else json.dumps(body).encode(),
        headers={'Authorization': token} if token else {})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def top1_agreement(logits, ref):
    """(raw, tie-aware) share of positions whose argmax over ``logits``
    is the argmax over ``ref`` (see TIE_DELTA)."""
    pick = logits.argmax(dim=-1)
    ref_max, ref_pick = ref.max(dim=-1)
    raw = float((pick == ref_pick).float().mean())
    picked = ref.gather(-1, pick.unsqueeze(-1)).squeeze(-1)
    tie = float((picked >= ref_max - TIE_DELTA).float().mean())
    return raw, tie


def phase_serving(seed: int):
    from mlcomp_tpu_torch import MODEL_FOLDER, TOKEN
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.ops.flash_attention import flash_attention_forward
    from mlcomp_tpu_torch.server.serve import ModelServer, resolve_model
    from mlcomp_tpu_torch.train.export import export_model

    t0 = time.monotonic()
    params = flagship_params(seed)
    export_model(os.path.join(MODEL_FOLDER, 'smoke', 'flagship_lm'), params,
                 FLAGSHIP, meta={'input_shape': [FLAGSHIP['max_seq_len']],
                                 'input_dtype': 'int32'})
    del params
    path = resolve_model('flagship_lm', 'smoke')
    export_s = time.monotonic() - t0
    t0 = time.monotonic()
    server = ModelServer(path, batch_size=SERVE_BATCH, activation='argmax',
                         port=0, device='cuda')
    load_s = time.monotonic() - t0
    t0 = time.monotonic()
    if not server.warmup():
        fail('export carries no input_shape to warm up with')
    warm_s = time.monotonic() - t0
    server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    model = server.primary.predict.model
    say('serve', export_s=f'{export_s:.1f}', load_s=f'{load_s:.1f}',
        warmup_s=f'{warm_s:.2f}', port=server.port,
        params=sum(p.numel() for p in model.parameters()))
    try:
        rng = np.random.default_rng(seed + 1)
        t, vocab = FLAGSHIP['max_seq_len'], FLAGSHIP['vocab_size']
        requests = [rng.integers(0, vocab, (n, t), dtype=np.int32)
                    for n in REQUEST_ROWS]
        latencies, served = [], []
        # the main path: counts zeroed just before, read just after
        flash_attention_forward.launches = 0
        per_dispatch = []
        for x in requests:
            before = flash_attention_forward.launches
            t1 = time.monotonic()
            out = _http(server.port, '/predict', {'x': x.tolist()}, TOKEN)
            latencies.append((time.monotonic() - t1) * 1e3)
            per_dispatch.append(flash_attention_forward.launches - before)
            y = np.asarray(out['y'])
            if y.shape != x.shape or not np.issubdtype(y.dtype, np.integer) \
                    or y.min() < 0 or y.max() >= vocab:
                fail(f'/predict answered shape {y.shape} dtype {y.dtype} '
                     f'for {x.shape} tokens')
            served.append(y)
        launches = flash_attention_forward.launches
        health = _http(server.port, '/health')
        say('serve', requests=len(requests), rows=list(REQUEST_ROWS),
            launches=launches, per_dispatch=per_dispatch,
            p50_ms=f'{float(np.percentile(latencies, 50)):.1f}',
            max_ms=f'{max(latencies):.1f}',
            health_p50_ms=health['models']['flagship_lm']['latency_ms'][
                'p50'],
            health=health['status'], platform=health['platform'],
            device=repr(health['device']))
        if health['status'] != 'ok' or health['platform'] != 'gpu' \
                or health['requests'] != len(requests):
            fail(f'/health disagrees: {health}')
        if per_dispatch != [FLAGSHIP['n_layers']] * len(requests):
            fail(f'expected {FLAGSHIP["n_layers"]} flash launches per '
                 f'dispatch, got {per_dispatch}')

        # where a dispatch's time goes: the model's forward at the served
        # batch shape on the card, against the request as the client saw it
        batch = torch.from_numpy(np.concatenate(requests[:2])[:SERVE_BATCH]
                                 ).cuda()
        with torch.inference_mode():
            forward_ms = time_ms(lambda: model(batch).argmax(dim=-1),
                                 iters=3)
        say('serve', forward_ms=f'{forward_ms:.2f}',
            batch=SERVE_BATCH)

        # one row against the same weights with the plain attention
        tokens = torch.from_numpy(requests[0]).cuda()
        dense = create_model(**{**FLAGSHIP, 'attn_impl': 'dense'},
                             device='cuda')
        dense.load_state_dict(model.state_dict())
        with torch.inference_mode():
            kern = model(tokens)[0].float()
            ref = dense(tokens)[0].float()
        del dense
        finite = bool(torch.isfinite(kern).all() and torch.isfinite(ref).all())
        cos = float(torch.nn.functional.cosine_similarity(
            kern.reshape(1, -1), ref.reshape(1, -1)))
        raw, tie = top1_agreement(kern, ref)
        served_row = torch.from_numpy(served[0][0]).cuda().long()
        picked = ref.gather(-1, served_row[:, None]).squeeze(-1)
        served_tie = float((picked >= ref.max(dim=-1).values - TIE_DELTA)
                           .float().mean())
        say('compare', finite=finite, cosine=f'{cos:.6f}',
            top1_raw=f'{raw:.4f}', top1_tie_aware=f'{tie:.4f}',
            served_top1_tie_aware=f'{served_tie:.4f}',
            max_abs_logit_err=f'{float((kern - ref).abs().max()):.4f}',
            min_cosine=MIN_COSINE, min_top1=MIN_TOP1)
        if not finite or cos < MIN_COSINE or tie < MIN_TOP1 \
                or served_tie < MIN_TOP1:
            fail('served LM disagrees with the plain-attention reference')
        return launches
    finally:
        server.shutdown()
        thread.join(timeout=30)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false — this smoke run needs '
             'an NVIDIA card')
    # a fresh root (its models/ folder) for the export, set before the
    # package computes MODEL_FOLDER at import
    root = tempfile.mkdtemp(prefix='mlcomp_smoke_')
    os.environ['MLCOMP_TPU_ROOT'] = root
    try:
        try:
            import mlcomp_tpu_torch  # noqa: F401
        except ImportError as e:
            fail(f'the mlcomp_tpu_torch package is not beside this '
                 f'script: {e}')
        torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
        torch.backends.cudnn.allow_tf32 = False

        smi = phase_device()
        phase_build()
        main_kernel = phase_kernels(args.seed)
        launches = phase_serving(args.seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if launches <= 0:
        fail('the main path launched no flash_attention_fwd')
    main_kernel['launches'] = launches
    print(json.dumps({'kernels': [main_kernel]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
