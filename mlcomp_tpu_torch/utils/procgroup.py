"""Autorestarting process group (port of
``mlcomp_tpu/utils/procgroup.py``), used by
``python -m mlcomp_tpu_torch.worker start``. Backoff is per child and
does not block: a crash-looping child waits out its delay while every
other child keeps being supervised."""

import signal
import subprocess
import sys
import time


def run_process_group(specs, banner: str = None, poll_interval: float = 2.0,
                      fast_exit_window: float = 10.0,
                      max_backoff: float = 30.0, should_stop=None,
                      install_signal: bool = True):
    """Spawn one child per spec (an argv suffix run as
    ``python <argv...>``, e.g. ``['-m', 'mlcomp_tpu_torch.worker',
    'worker', '0']``) and babysit: restart on exit, with exponential
    per-child backoff while a child keeps dying within
    ``fast_exit_window`` seconds of its spawn. SIGTERM or Ctrl-C
    terminates the group. ``should_stop`` is polled each loop; True
    terminates the group and returns the children instead of
    exiting."""
    children = {}        # idx -> Popen | None (None = waiting to respawn)
    spawned_at = {}
    restart_at = {}
    fail_streak = [0] * len(specs)

    def spawn(idx):
        children[idx] = subprocess.Popen([sys.executable] + list(specs[idx]))
        spawned_at[idx] = time.time()

    for i in range(len(specs)):
        spawn(i)
    if banner:
        print(banner, flush=True)

    def terminate_children():
        for proc in children.values():
            if proc is not None and proc.poll() is None:
                proc.terminate()

    def shutdown(*_):
        terminate_children()
        sys.exit(0)

    if install_signal:
        signal.signal(signal.SIGTERM, shutdown)
    try:
        while True:
            time.sleep(poll_interval)
            if should_stop is not None and should_stop():
                terminate_children()
                for proc in children.values():
                    if proc is not None:  # reap: no zombies for the caller
                        try:
                            proc.wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            proc.kill()
                            proc.wait(timeout=5)
                return children
            now_t = time.time()
            for idx in range(len(specs)):
                proc = children.get(idx)
                if proc is not None and proc.poll() is not None:
                    fast = now_t - spawned_at[idx] < fast_exit_window
                    fail_streak[idx] = fail_streak[idx] + 1 if fast else 0
                    delay = min(max_backoff, 2 ** fail_streak[idx]) \
                        if fast else 0
                    print(f'child {specs[idx]} exited '
                          f'({proc.returncode}); restarting'
                          + (f' in {delay:.0f}s' if delay else ''),
                          flush=True)
                    children[idx] = None
                    restart_at[idx] = now_t + delay
                if children.get(idx) is None \
                        and now_t >= restart_at.get(idx, 0):
                    spawn(idx)
    except KeyboardInterrupt:
        shutdown()


__all__ = ['run_process_group']
