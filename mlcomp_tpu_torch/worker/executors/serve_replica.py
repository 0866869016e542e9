"""``serve_replica`` executor — one serving replica as a supervisor-
scheduled Service task (the fleet tier, server/fleet.py; port of
``mlcomp_tpu/worker/executors/serve_replica.py``).

The task's ``additional_info['serve']`` (written by the fleet
reconciler at spawn, merged with the executor's own ``serve`` options
from the fleet's dag) names the fleet, the replica row, the generation
and the export to serve. ``work()``:

1. resolves the export and builds a ``ModelServer`` on an ephemeral
   port (``serve.py`` — the same server the ``serve`` CLI runs), on the
   card unless ``serve['device']`` asks for the CPU: a replica that
   finds no CUDA fails its task, it never serves on the CPU instead;
2. **warms the predictor BEFORE binding**: the rolling-swap contract is
   that a generation flips only when its replicas answer health probes,
   and a probe must never succeed against a replica whose first request
   would pay the kernel load and the allocator's first growth. An
   export whose meta carries no ``input_shape`` cannot be warmed, and
   the replica fails its task rather than bind cold (JAX's binds);
3. reports the bound endpoint into the replica row
   (``ReplicaProvider.mark_endpoint``) — the reconciler's probes and
   the gateway's routing table key on it;
4. beats: touches ``task.last_activity`` every few seconds (the
   reconciler's heartbeat-silence horizon reads it) and flushes the
   serving latency histograms;
5. serves until SIGTERM (``run-task`` turns it into ``SystemExit``),
   then drains in-flight requests (``graceful_shutdown``) so a swap
   retirement or a routed kill never fails the requests it interrupts.

The replica is otherwise a NORMAL task: lease reclaim, the failure
taxonomy, ``kill_task`` routing and placement exclusion all apply to it
as they do to a trainer.
"""

import threading

from mlcomp_tpu_torch.db.enums import ComponentType
from mlcomp_tpu_torch.worker.executors.base import Executor


@Executor.register
class ServeReplica(Executor):
    #: seconds between heartbeats (last_activity touch + metric flush)
    beat_interval_s = 5.0

    def __init__(self, **kwargs):
        self.options = kwargs

    def work(self):
        from mlcomp_tpu_torch.db.providers import (
            ReplicaProvider, TaskProvider,
        )
        from mlcomp_tpu_torch.server.serve import ModelServer, resolve_model
        from mlcomp_tpu_torch.testing.faults import fault_point
        from mlcomp_tpu_torch.utils.misc import hostname
        info = getattr(self, 'additional_info', None) or {}
        serve = dict(info.get('serve') or {})
        serve.update(self.options.get('serve') or {})
        replica_id = serve.get('replica')
        model = serve.get('model')
        if not model:
            raise ValueError('serve_replica task carries no model '
                             "(additional_info['serve']['model'])")
        path = resolve_model(model, serve.get('project'))
        server = ModelServer(
            path,
            batch_size=int(serve.get('batch_size') or 64),
            activation=serve.get('activation'),
            quantize=serve.get('quantize'),
            host=serve.get('host', '0.0.0.0'),
            port=int(serve.get('port', 0)),
            max_pending=int(serve.get('max_pending') or 256),
            device=serve.get('device', 'cuda'))
        if not server.warmup():         # the predictor runs BEFORE binding
            server.shutdown()
            raise ValueError(
                f'export {path!r} carries no input_shape in its meta: a '
                f'replica warms its predictor before it binds, and this '
                f'one cannot')
        port = server.bind()
        self.server = server            # test/introspection handle
        ip = self._advertise_ip(hostname())
        url = f'http://{ip}:{port}'
        if replica_id is not None:
            ReplicaProvider(self.session).mark_endpoint(
                replica_id, hostname(), port, url)
        if self.logger is not None:
            self.logger.info(
                f'fleet {serve.get("fleet_name")}: replica '
                f'{replica_id} generation {serve.get("generation")} '
                f'serving {model} on {url} (warmup=done, '
                f'device={server.device_info["device"]})',
                ComponentType.Worker, None,
                self.task.id if self.task else None)

        tasks = TaskProvider(self.session)
        stop_beat = threading.Event()

        def beat():
            while not stop_beat.wait(self.beat_interval_s):
                # chaos seam: an armed replica.crash kills THIS replica
                # process uncleanly (no drain), the stand-in for a
                # preempted or OOM-killed serving box
                fault_point('replica.crash',
                            fleet=serve.get('fleet_name'),
                            replica=replica_id, phase='beat')
                try:
                    if self.task is not None:
                        tasks.update_last_activity(self.task.id)
                    server.telemetry.flush(self.session)
                except Exception:
                    pass        # a DB hiccup must not kill serving

        beat_thread = threading.Thread(target=beat, daemon=True)
        beat_thread.start()
        try:
            server.serve_forever()      # until SIGTERM → SystemExit
        finally:
            stop_beat.set()
            # drain in flight, then close — a swap retirement or a
            # routed kill must not fail the requests it interrupts
            try:
                server.graceful_shutdown(
                    drain_timeout_s=float(
                        serve.get('drain_timeout_s', 30.0)))
            except Exception:
                pass
            beat_thread.join(timeout=2)
        return {'replica': replica_id, 'url': url,
                'requests': int(server.requests)}

    def _advertise_ip(self, host: str) -> str:
        """The address peers reach this replica at: the computer row's
        registered ip when one exists (multi-host deployment), else
        loopback (single-box and test clusters)."""
        try:
            row = self.session.query_one(
                'SELECT ip FROM computer WHERE name=?', (host,))
            if row and row['ip']:
                return row['ip']
        except Exception:
            pass
        return '127.0.0.1'


__all__ = ['ServeReplica']
