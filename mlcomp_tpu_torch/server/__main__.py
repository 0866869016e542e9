"""Server CLI of the port (counterpart of ``mlcomp_tpu/server/__main__.py``;
argparse, since the card's machine has no click).

    python -m mlcomp_tpu_torch.server start-site [--host H] [--port N]
        [--no-supervisor]
    python -m mlcomp_tpu_torch.server start N [--in-process]
    python -m mlcomp_tpu_torch.server stop
    python -m mlcomp_tpu_torch.server serve NAME [NAME ...] [--project P]
        [--host H] [--port N] [--batch-size B] [--activation A]
        [--quantize int8] [--coalesce-ms W] [--register]
        [--max-pending N] [--drain-timeout S] [--device cuda|cpu]
    python -m mlcomp_tpu_torch.server gateway [--host H] [--port N]
        [--refresh S] [--hedge-ratio R] [--flush-every S]
    python -m mlcomp_tpu_torch.server fleet-create NAME MODEL [--project P]
        [--replicas N] [--slo-p99-ms MS] [--cores N] [--batch-size B]
        [--quantize int8] [--max-pending N] [--priority CLASS]
        [--activation A]
    python -m mlcomp_tpu_torch.server fleet-swap NAME MODEL
    python -m mlcomp_tpu_torch.server fleet-scale NAME REPLICAS
    python -m mlcomp_tpu_torch.server fleet-stop NAME

``start-site`` migrates the DB and runs the HA supervisor loop and the
JSON API with the dashboard in this process (``WEB_HOST``:``WEB_PORT``
of ``configs/.env`` unless ``--host``/``--port`` say otherwise); SIGTERM
releases the supervisor's lease and exits 0. The site imports no torch:
the card's memory belongs to the workers. ``start N`` runs ``start-site``,
the host agent (``worker-supervisor``) and N workers as an autorestarting
process group; ``stop`` SIGTERMs every process of the port's server and
worker commands on this host, group parents first.

Each NAME of ``serve`` is an export name under ``MODEL_FOLDER/<project>/`` or a path
to a ``.msgpack`` export (written by either package). SIGTERM/SIGINT
drain: new predicts get 503 while in-flight ones finish (bounded by
``--drain-timeout``); a second signal closes at once. ``--quantize
int8`` serves the export's large 2-D projections as weight-only int8
through the hand-written int8 matmul kernel (``train/export.py``).
``--register`` heartbeats the served models into the DB's ``auxiliary``
table (``serving:<model>:<port>``) with the metric and span flushes;
the drain deregisters.

``fleet-create`` declares a serving fleet (server/fleet.py): the site's
supervisor reconciles it into ``serve_replica`` tasks its workers run, a
replica a worker for its life. ``--cores 0`` asks for no card slot, so
several replicas share a card. ``--activation`` is the port's: it is
applied by every replica (a fleet of a language model answers token
ids with ``argmax``). ``gateway`` runs the routing gateway
(server/gateway.py) in front of the fleets: ``POST /predict/<fleet>``
goes to a healthy replica of the active generation, with circuit
breaking, hedged retry and SLO-keyed shedding; it imports no torch.
``fleet-swap`` stages a rolling swap to another export, ``fleet-scale``
changes the desired count and ``fleet-stop`` retires the fleet (its
replicas drain). An unknown fleet is ``Error: ...`` with exit code 1.
"""

import argparse
import os
import re
import signal
import sys
import threading


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='python -m mlcomp_tpu_torch.server')
    sub = parser.add_subparsers(dest='command', required=True)
    site = sub.add_parser(
        'start-site', help='migrate, then run the supervisor loop and the '
                           'JSON API with the dashboard in this process')
    site.add_argument('--host', default=None)
    site.add_argument('--port', type=int, default=None)
    site.add_argument('--no-supervisor', action='store_true',
                      help='serve the API without the scheduler loop')
    start = sub.add_parser(
        'start', help='start-site + worker-supervisor + N workers, '
                      'restarted when they exit')
    start.add_argument('n_workers', type=int)
    start.add_argument('--in-process', action='store_true',
                       help='the workers run tasks inside the daemon')
    sub.add_parser('stop', help='stop the processes start spawned')
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
                       help='heartbeat into the DB registry (auxiliary '
                            'table) so the dashboard lists this endpoint')
    serve.add_argument('--max-pending', type=int, default=256,
                       help='per-model bound on in-flight requests; '
                            'beyond it clients get 429')
    serve.add_argument('--drain-timeout', type=float, default=30.0,
                       help='seconds SIGTERM waits for in-flight '
                            'requests before shutting down')
    serve.add_argument('--device', default='cuda',
                       help="'cuda' (default) or 'cpu'")
    gateway = sub.add_parser(
        'gateway', help='run the fleet routing gateway: POST '
                        '/predict/<fleet> to healthy replicas')
    gateway.add_argument('--host', default='127.0.0.1')
    gateway.add_argument('--port', type=int, default=4300)
    gateway.add_argument('--refresh', type=float, default=2.0,
                         help='seconds between DB refreshes of the '
                              'routing table')
    gateway.add_argument('--hedge-ratio', type=float, default=0.1,
                         help='fraction of traffic that may spend a '
                              'hedged retry')
    gateway.add_argument('--flush-every', type=float, default=15.0,
                         help='seconds between telemetry flushes (shed '
                              'counters, latency buckets) into the DB')
    create = sub.add_parser(
        'fleet-create', help='register a serving fleet: REPLICAS replicas '
                             'of export MODEL')
    create.add_argument('name')
    create.add_argument('model')
    create.add_argument('--project', default=None)
    create.add_argument('--replicas', type=int, default=2)
    create.add_argument('--slo-p99-ms', type=float, default=250.0)
    create.add_argument('--cores', type=int, default=1)
    create.add_argument('--batch-size', type=int, default=64)
    create.add_argument('--quantize', default=None)
    create.add_argument('--max-pending', type=int, default=256)
    create.add_argument('--priority', default=None,
                        choices=('critical', 'high', 'normal',
                                 'preemptible'),
                        help='scheduling class for the replicas (default: '
                             'the serve-replica class default, high)')
    create.add_argument('--activation', default=None,
                        choices=('softmax', 'sigmoid', 'argmax'),
                        help="applied by every replica to the model's "
                             'output')
    swap = sub.add_parser(
        'fleet-swap', help='rolling swap of fleet NAME to export MODEL')
    swap.add_argument('name')
    swap.add_argument('model')
    scale = sub.add_parser('fleet-scale',
                           help="change fleet NAME's desired replica count")
    scale.add_argument('name')
    scale.add_argument('replicas', type=int)
    fstop = sub.add_parser(
        'fleet-stop', help='retire fleet NAME: replicas drain and their '
                           'tasks stop')
    fstop.add_argument('name')
    return parser


def start_site(args):
    from mlcomp_tpu_torch import WEB_HOST, WEB_PORT
    from mlcomp_tpu_torch.db.core import Session
    from mlcomp_tpu_torch.db.enums import ComponentType
    from mlcomp_tpu_torch.server.api import start_server
    from mlcomp_tpu_torch.utils.logging import create_logger
    session = Session.create_session(key='server_site')
    logger = create_logger(session)
    logger.info(f'API on {args.host or WEB_HOST}:{args.port or WEB_PORT}',
                ComponentType.API)
    start_server(host=args.host, port=args.port, logger=logger,
                 with_supervisor=not args.no_supervisor)


def start(args):
    from mlcomp_tpu_torch import WEB_HOST, WEB_PORT
    from mlcomp_tpu_torch.utils.procgroup import run_process_group
    specs = [
        ['-m', 'mlcomp_tpu_torch.server', 'start-site'],
        ['-m', 'mlcomp_tpu_torch.worker', 'worker-supervisor'],
    ] + [
        ['-m', 'mlcomp_tpu_torch.worker', 'worker', str(i)]
        + (['--in-process'] if args.in_process else [])
        for i in range(args.n_workers)
    ]
    run_process_group(
        specs, banner=f'started site + worker-supervisor + '
                      f'{args.n_workers} workers '
                      f'(http://{WEB_HOST}:{WEB_PORT})')


#: a process group parent of the port (``server start``, ``worker
#: start``): stopped before its children, so it cannot restart them
_GROUP_PARENT = re.compile(r'mlcomp_tpu_torch\.(server|worker) start( |$)')


def stop(args):
    """SIGTERM the port's server and worker processes on this host (by
    command line, through ``/proc``), group parents first."""
    from mlcomp_tpu_torch.utils import procfs
    me = os.getpid()
    cmds = {pid: procfs.process_cmdline(pid)
            for pid in procfs.process_pids() if pid != me}
    ours = [pid for pid, cmd in cmds.items()
            if 'mlcomp_tpu_torch.server' in cmd
            or 'mlcomp_tpu_torch.worker' in cmd]
    ours.sort(key=lambda pid: not _GROUP_PARENT.search(cmds[pid]))
    for pid in ours:
        try:
            os.kill(pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
    print('stopped', flush=True)


def serve(args):
    from mlcomp_tpu_torch.server.serve import ModelServer, resolve_model
    paths = [resolve_model(m, args.project) for m in args.model]
    server = ModelServer(paths, batch_size=args.batch_size,
                         activation=args.activation,
                         quantize=args.quantize, host=args.host,
                         port=args.port, coalesce_ms=args.coalesce_ms,
                         max_pending=args.max_pending, device=args.device)
    warmed = server.warmup()
    server.bind()
    if args.register:
        from mlcomp_tpu_torch.db.core import Session
        server.start_heartbeat(Session.create_session(key='serve'))
    print(f'serving {", ".join(server.models)} on '
          f'http://{args.host}:{server.port} '
          f'(device={server.device_info["device"]}, '
          f'warmup={"done" if warmed else "first-request"}, '
          f'quantize={args.quantize or "none"}'
          f'{", registered" if args.register else ""})', flush=True)

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


def _fleet_session():
    from mlcomp_tpu_torch.db.core import Session
    from mlcomp_tpu_torch.db.migration import migrate
    session = Session.create_session(key='fleet_cli')
    migrate(session)
    return session


def _fleet(session, name: str):
    from mlcomp_tpu_torch.db.providers import FleetProvider
    fleet = FleetProvider(session).by_name(name)
    if fleet is None:
        print(f'Error: no fleet {name!r}', file=sys.stderr)
        raise SystemExit(1)
    return fleet


def gateway(args):
    """The fleet routing gateway (server/gateway.py), its routing table
    refreshed from the fleet tables the supervisor's reconciler keeps;
    a thread flushes its counters and spans every ``--flush-every``
    seconds."""
    import time
    from mlcomp_tpu_torch.db.core import Session
    from mlcomp_tpu_torch.db.migration import migrate
    from mlcomp_tpu_torch.server.gateway import FleetGateway
    session = Session.create_session(key='gateway')
    migrate(session)
    gw = FleetGateway(host=args.host, port=args.port, session=session,
                      refresh_s=args.refresh, hedge_ratio=args.hedge_ratio)
    gw.bind()

    def flusher():
        while True:
            time.sleep(args.flush_every)
            try:
                gw.flush_telemetry(session)
            except Exception:
                pass
    threading.Thread(target=flusher, daemon=True).start()
    print(f'gateway on http://{args.host}:{gw.port} '
          f'(refresh {args.refresh}s, hedge ratio {args.hedge_ratio})',
          flush=True)
    gw.serve_forever()


def fleet_create(args):
    from mlcomp_tpu_torch.server.fleet import create_fleet
    session = _fleet_session()
    try:
        fleet = create_fleet(
            session, args.name, args.model, project=args.project,
            desired=args.replicas, slo_p99_ms=args.slo_p99_ms,
            cores=args.cores, batch_size=args.batch_size,
            quantize=args.quantize, max_pending=args.max_pending,
            priority=args.priority, activation=args.activation)
    except ValueError as e:
        print(f'Error: {e}', file=sys.stderr)
        raise SystemExit(1)
    print(f'fleet {args.name} (id {fleet.id}): {args.replicas} replica(s) '
          f'of {args.model}, p99 SLO {args.slo_p99_ms}ms', flush=True)


def fleet_swap(args):
    from mlcomp_tpu_torch.server.fleet import start_swap
    session = _fleet_session()
    fleet = _fleet(session, args.name)
    try:
        start_swap(session, fleet, args.model)
    except ValueError as e:
        print(f'Error: {e}', file=sys.stderr)
        raise SystemExit(1)
    print(f'fleet {args.name}: swapping to {args.model} as generation '
          f'{fleet.target_generation}', flush=True)


def fleet_scale(args):
    from mlcomp_tpu_torch.db.providers import FleetProvider
    session = _fleet_session()
    fleet = _fleet(session, args.name)
    fleet.desired = int(args.replicas)
    FleetProvider(session).touch(fleet, ['desired'])
    print(f'fleet {args.name}: desired replicas = {args.replicas}',
          flush=True)


def fleet_stop(args):
    from mlcomp_tpu_torch.server.fleet import stop_fleet
    session = _fleet_session()
    stop_fleet(session, _fleet(session, args.name))
    print(f'fleet {args.name}: stopped', flush=True)


_COMMANDS = {'start-site': start_site, 'start': start, 'stop': stop,
             'serve': serve, 'gateway': gateway,
             'fleet-create': fleet_create, 'fleet-swap': fleet_swap,
             'fleet-scale': fleet_scale, 'fleet-stop': fleet_stop}


def main(argv=None):
    args = _parser().parse_args(argv)
    _COMMANDS[args.command](args)


if __name__ == '__main__':
    sys.exit(main())
