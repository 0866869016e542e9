"""Synthetic sweep cell (port of
``mlcomp_tpu/worker/executors/sweep_probe.py``) — the torch-free stand-in
a scheduling test needs (registered builtin, like ``serve_replica``).

The sweep tests measure the SCHEDULER: rung reports, prune latency,
slot recycling, wallclock vs exhaustive. Real CIFAR cells would drown
those numbers in per-cell start-up costs. A probe cell "trains" by
sleeping ``epoch_s`` per epoch, reports a **deterministic** score
curve derived from its grid params — so exhaustive and sweep-scheduled
runs agree on the best cell bit-for-bit — and polls its own task row
so a prune verdict (status flipped Failed by the supervisor) stops it
at the next epoch boundary even in in-process worker mode where no
SIGTERM arrives.
"""

import math
import time

from mlcomp_tpu_torch.worker.executors import Executor


def probe_score(lr: float, seed: int, epoch: int) -> float:
    """Deterministic 'accuracy' after ``epoch`` epochs (1-based).

    Monotone in ``epoch`` for every cell, with a per-cell ceiling
    keyed to how close ``lr`` sits to the sweet spot 0.1 plus a small
    stable seed offset — cells keep their relative ORDER at every
    rung, so ASHA's surviving best equals the exhaustive best exactly
    (the bench's 1e-6 agreement floor)."""
    quality = 1.0 / (1.0 + abs(math.log10(max(float(lr), 1e-9) / 0.1)))
    quality += 0.01 * ((int(seed) * 2654435761) % 97) / 97.0
    return quality * (1.0 - 0.5 ** int(epoch))


@Executor.register
class SweepProbe(Executor):
    def __init__(self, lr=0.1, seed=0, epochs=8, epoch_s=0.05,
                 **kwargs):
        self.lr = float(lr)
        self.seed = int(seed)
        self.epochs = int(epochs)
        self.epoch_s = float(epoch_s)

    #: status-poll cadence inside an epoch sleep — bounds how long a
    #: judged loser keeps burning its slot past the verdict (a real
    #: trainer gets SIGTERM'd instead; the in-process probe polls)
    POLL_S = 0.25

    def _pruned(self) -> bool:
        from mlcomp_tpu_torch.contrib.search.asha import cell_is_terminal
        if self.session is None or self.task is None:
            return False
        return cell_is_terminal(self.session, self.task.id)

    def _sleep_epoch(self) -> bool:
        """One epoch of 'training'; True when a prune verdict landed
        mid-epoch (one cheap indexed status read per POLL_S slice)."""
        remaining = self.epoch_s
        while remaining > 0:
            time.sleep(min(self.POLL_S, remaining))
            remaining -= self.POLL_S
            if remaining > 0 and self._pruned():
                return True
        return False

    def work(self):
        from mlcomp_tpu_torch.contrib.search.asha import report_sweep_score
        from mlcomp_tpu_torch.db.providers import TaskProvider
        cell_id = (self.task.parent or self.task.id) \
            if self.task is not None else None
        best = None
        done = 0
        for epoch in range(1, self.epochs + 1):
            if self._sleep_epoch():
                return {'pruned_at': epoch - 1, 'score': best}
            score = probe_score(self.lr, self.seed, epoch)
            done = epoch
            if self.session is not None and cell_id is not None:
                report_sweep_score(self.session, cell_id, epoch, score)
                if best is None or score > best:
                    best = score
                    # best-so-far onto the task row, like the trainer's
                    # _update_scores — the sweep summary ranks by it
                    self.task.score = float(score)
                    TaskProvider(self.session).update(
                        self.task, ['score'])
            if epoch < self.epochs and self._pruned():
                # the supervisor judged this cell a loser; stop NOW so
                # the slot frees even without a signal (in-process
                # worker). The Failed/sweep-pruned status is already
                # on the row — returning does not overwrite it.
                return {'pruned_at': epoch, 'score': best}
        return {'epochs': done, 'score': best, 'lr': self.lr,
                'seed': self.seed}


__all__ = ['SweepProbe', 'probe_score']
