"""Background interval scheduler (port of
``mlcomp_tpu/utils/schedule.py``): one daemon thread per job, never
overlapping runs of the same job, exceptions logged and swallowed so a
bad run cannot kill the loop."""

import threading
import traceback


class _Job(threading.Thread):
    def __init__(self, fn, interval: float, name: str, logger=None):
        super().__init__(daemon=True, name=f'schedule-{name}')
        self.fn = fn
        self.interval = interval
        self.logger = logger
        # NOT named _stop: threading.Thread.join() calls self._stop()
        self._stop_evt = threading.Event()

    def run(self):
        while not self._stop_evt.wait(self.interval):
            try:
                self.fn()
            except Exception:
                msg = f'scheduled job {self.name} failed:\n' \
                      f'{traceback.format_exc()}'
                if self.logger is not None:
                    try:
                        self.logger.error(msg)
                    except Exception:
                        pass
                else:
                    print(msg)

    def stop(self):
        self._stop_evt.set()


def start_schedule(jobs, logger=None):
    """``jobs``: list of (fn, interval_seconds). Returns the started
    jobs (``.stop()`` cancels one)."""
    started = []
    for fn, interval in jobs:
        job = _Job(fn, interval, getattr(fn, '__name__', 'job'),
                   logger=logger)
        job.start()
        started.append(job)
    return started


__all__ = ['start_schedule']
