"""Host telemetry and process lookups over ``/proc`` and ``statvfs``:
the plain-Python counterparts of ``mlcomp_tpu/native``'s
``cpu_percent``, ``memory_percent``, ``disk_percent`` and
``pid_exists``, and of the ``psutil`` calls the JAX worker daemon
makes (process environment, command line, children). Linux only, as
the daemon is."""

import os
import time

_cpu_prev = None


def _cpu_sample():
    with open('/proc/stat') as fh:
        fields = [float(v) for v in fh.readline().split()[1:9]]
    total = sum(fields)
    busy = total - fields[3] - fields[4]  # minus idle, iowait
    return busy, total


def cpu_percent() -> float:
    """Host CPU busy share since the previous call (the first call
    samples over 80 ms)."""
    global _cpu_prev
    try:
        if _cpu_prev is None:
            _cpu_prev = _cpu_sample()
            time.sleep(0.08)
        busy, total = _cpu_sample()
        pbusy, ptotal = _cpu_prev
        _cpu_prev = (busy, total)
        if total <= ptotal:
            return 0.0
        return min(100.0, max(0.0, 100.0 * (busy - pbusy)
                              / (total - ptotal)))
    except OSError:
        return 0.0


def _meminfo() -> dict:
    info = {}
    with open('/proc/meminfo') as fh:
        for line in fh:
            key, _, rest = line.partition(':')
            info[key] = float(rest.split()[0])
    return info


def memory_percent() -> float:
    try:
        info = _meminfo()
        total, avail = info['MemTotal'], info['MemAvailable']
        return 100.0 * (total - avail) / total
    except (OSError, KeyError, IndexError, ZeroDivisionError):
        return 0.0


def memory_gb():
    """(total, available) host memory in GB."""
    info = _meminfo()
    return info['MemTotal'] / 2 ** 20, info['MemAvailable'] / 2 ** 20


def disk_percent(path: str) -> float:
    try:
        st = os.statvfs(path)
        used = (st.f_blocks - st.f_bfree) * st.f_frsize
        usable = used + st.f_bavail * st.f_frsize
        return 100.0 * used / usable if usable else 0.0
    except OSError:
        return 0.0


def disk_gb(path: str):
    """(total, free) disk space in GB of the filesystem holding
    ``path``."""
    st = os.statvfs(path)
    return (st.f_frsize * st.f_blocks / 2 ** 30,
            st.f_frsize * st.f_bavail / 2 ** 30)


def pid_exists(pid: int) -> bool:
    """Whether ``pid`` runs. A zombie does not: a task process whose
    parent died with it stays one until something reaps it."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f'/proc/{pid}/stat') as fh:
            return fh.read().rsplit(')', 1)[1].split()[0] != 'Z'
    except (OSError, IndexError):
        return True


def process_environ(pid: int) -> dict:
    """The environment ``pid`` was started with; {} where unreadable."""
    try:
        with open(f'/proc/{pid}/environ', 'rb') as fh:
            raw = fh.read()
    except OSError:
        return {}
    out = {}
    for item in raw.split(b'\0'):
        key, sep, value = item.partition(b'=')
        if sep:
            out[key.decode(errors='replace')] = \
                value.decode(errors='replace')
    return out


def process_cmdline(pid: int) -> str:
    """The command line of ``pid``, arguments joined by spaces; '' where
    unreadable."""
    try:
        with open(f'/proc/{pid}/cmdline', 'rb') as fh:
            raw = fh.read()
    except OSError:
        return ''
    return ' '.join(a.decode(errors='replace')
                    for a in raw.split(b'\0') if a)


def process_pids():
    """Every pid in ``/proc``."""
    return [int(d) for d in os.listdir('/proc') if d.isdigit()]


def _parent_of(pid: int):
    try:
        with open(f'/proc/{pid}/stat') as fh:
            stat = fh.read()
    except OSError:
        return None
    # the command name (field 2) may hold spaces and parentheses
    return int(stat.rsplit(')', 1)[1].split()[1])


def child_pids(parent_pid: int):
    """Every descendant of ``parent_pid``."""
    children = {}
    for pid in process_pids():
        ppid = _parent_of(pid)
        if ppid is not None:
            children.setdefault(ppid, []).append(pid)
    out, stack = [], [parent_pid]
    while stack:
        for child in children.get(stack.pop(), []):
            out.append(child)
            stack.append(child)
    return out


def kill_child_processes(parent_pid: int, sig=15):
    """Signal the whole process subtree under ``parent_pid``."""
    for pid in child_pids(parent_pid):
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass


__all__ = ['cpu_percent', 'memory_percent', 'memory_gb', 'disk_percent',
           'disk_gb', 'pid_exists', 'process_environ', 'process_cmdline',
           'process_pids', 'child_pids', 'kill_child_processes']
