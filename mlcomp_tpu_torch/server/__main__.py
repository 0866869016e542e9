"""Server CLI of the port (counterpart of ``mlcomp_tpu/server/__main__.py``
``serve``; argparse, since the card's machine has no click).

    python -m mlcomp_tpu_torch.server serve NAME [NAME ...] [--project P]
        [--host H] [--port N] [--batch-size B] [--activation A]
        [--quantize int8] [--coalesce-ms W] [--max-pending N]
        [--drain-timeout S] [--device cuda|cpu]

Each NAME is an export name under ``MODEL_FOLDER/<project>/`` or a path
to a ``.msgpack`` export (written by either package). SIGTERM/SIGINT
drain: new predicts get 503 while in-flight ones finish (bounded by
``--drain-timeout``); a second signal closes at once. ``--quantize
int8`` serves the export's large 2-D projections as weight-only int8
through the hand-written int8 matmul kernel (``train/export.py``).
``--register`` is not ported yet and fails with a pointer to its ROADMAP
item.
"""

import argparse
import signal
import sys
import threading


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='python -m mlcomp_tpu_torch.server')
    sub = parser.add_subparsers(dest='command', required=True)
    serve = sub.add_parser(
        'serve', help='serve model exports over HTTP (GET /health, '
                      'GET /metrics, POST /predict[/<name>])')
    serve.add_argument('model', nargs='+')
    serve.add_argument('--project', default=None,
                       help='project folder to resolve MODEL(s) in')
    serve.add_argument('--host', default='127.0.0.1')
    serve.add_argument('--port', type=int, default=4202)
    serve.add_argument('--batch-size', type=int, default=64)
    serve.add_argument('--activation', default=None,
                       choices=('softmax', 'sigmoid', 'argmax'))
    serve.add_argument('--quantize', default=None, choices=('int8',),
                       help="'int8' = weight-only int8 serving (half the "
                            'weight bytes of bf16, a quarter of f32)')
    serve.add_argument('--coalesce-ms', type=float, default=0,
                       help='batch concurrent requests landing within '
                            'this many ms into one device dispatch '
                            '(0 = off)')
    serve.add_argument('--register', action='store_true',
                       help='heartbeat into the DB registry (not ported '
                            'yet)')
    serve.add_argument('--max-pending', type=int, default=256,
                       help='per-model bound on in-flight requests; '
                            'beyond it clients get 429')
    serve.add_argument('--drain-timeout', type=float, default=30.0,
                       help='seconds SIGTERM waits for in-flight '
                            'requests before shutting down')
    serve.add_argument('--device', default='cuda',
                       help="'cuda' (default) or 'cpu'")
    return parser


def serve(args, parser):
    if args.register:
        parser.error('--register needs the DB, which is not ported yet '
                     '(ROADMAP.md, queue A: the DB-backed heartbeat, '
                     'spans flush and --register)')
    from mlcomp_tpu_torch.server.serve import ModelServer, resolve_model
    paths = [resolve_model(m, args.project) for m in args.model]
    server = ModelServer(paths, batch_size=args.batch_size,
                         activation=args.activation,
                         quantize=args.quantize, host=args.host,
                         port=args.port, coalesce_ms=args.coalesce_ms,
                         max_pending=args.max_pending, device=args.device)
    warmed = server.warmup()
    server.bind()
    print(f'serving {", ".join(server.models)} on '
          f'http://{args.host}:{server.port} '
          f'(device={server.device_info["device"]}, '
          f'warmup={"done" if warmed else "first-request"}, '
          f'quantize={args.quantize or "none"})', flush=True)

    # polite termination: stop admitting (503), let in-flight requests
    # finish, close. Runs on ANOTHER thread (stdlib shutdown blocks
    # until the serve loop — this very thread — acknowledges)
    stops = {'n': 0}

    def _stop(signum, frame):
        stops['n'] += 1
        if stops['n'] == 1:
            threading.Thread(
                target=server.graceful_shutdown,
                kwargs={'drain_timeout_s': args.drain_timeout},
                daemon=True).start()
        else:
            print('second signal — forcing shutdown', flush=True)
            threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    server.serve_forever()


def main(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == 'serve':
        serve(args, parser)


if __name__ == '__main__':
    sys.exit(main())
