"""Slow runs of the port's host-bound training step in ``chip_smoke.py``'s
``[watchdog]`` phase, compared between two checkouts on one card.

The phase trains ``cifar_simple``'s ResNet-18 (S) in a ``run-task``
process, hangs it after epoch 1, and resumes it in a second attempt. Its
trainer records ``step_time_ms``, the host's interval between step calls,
and the supervisor's watchdog reads the newest 25 flushed samples of it:
``step-regression`` fires when the median of the newest 5 passes twice the
median of the older 20. This script runs the phase from checkout A and
from checkout B in the order given (``abba`` by default), keeps each
run's DB, and prints for each attempt of S:

- ``median_ms``: the median step;
- ``post_save``: the slowest 5-step median among the 32 steps after
  the first epoch boundary (the first checkpoint is written while they
  run), over ``median_ms``;
- ``seen_max``: the largest ratio the watchdog could read, over every
  window that ends at a flush of the trainer's recorder, and
  ``seen_over_2``: how many such windows pass 2;
- ``alerts``: the rules that alerted in the run.

Run it on the card, from this checkout, with a second checkout unpacked
in a directory that ``.gitignore`` lists::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/torch_step_contention.py --a build/parent --b .

Both checkouts share one kernel build (``MLCOMP_TPU_TORCH_BUILD``). The
DBs and a JSON summary land in ``--out`` (``build/step_contention/``).
"""
import argparse
import json
import os
import shutil
import sqlite3
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_phase(db_out: str):
    """In a checkout's root: ``[device]``, ``[build]`` and ``[watchdog]``
    of its ``chip_smoke.py``, the phase's DB copied to ``db_out`` before
    the phase removes its folder."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    remove = shutil.rmtree

    def keep(path, *args, **kwargs):
        db = os.path.join(str(path), 'root', 'db', 'sqlite.db')
        if os.path.basename(str(path)).startswith('watchdog_') and \
                os.path.exists(db):
            shutil.copy(db, db_out)
        return remove(path, *args, **kwargs)
    shutil.rmtree = keep
    smi = cs.phase_device()
    cs.phase_build()
    try:
        cs.phase_watchdog(smi)
    except SystemExit as e:
        print(f'[contention] phase failed: {e}', flush=True)


def attempts(db: str) -> list:
    """S's ``step_time_ms`` rows split by attempt (the step count
    restarts): ``[[(step, value, time), ...], ...]``."""
    conn = sqlite3.connect(db)
    rows = conn.execute("SELECT step, value, time FROM metric WHERE "
                        "name='step_time_ms' ORDER BY id").fetchall()
    conn.close()
    out = []
    for row in rows:
        if not out or row[0] < out[-1][-1][0]:
            out.append([])
        out[-1].append(row)
    return out


def summarise(rows: list) -> dict:
    values = [v for _, v, _ in rows]
    median = statistics.median(values)
    # a window the watchdog can read ends where a flush's batch ends
    ends = [i + 1 for i in range(len(rows))
            if i + 1 == len(rows) or rows[i + 1][2] != rows[i][2]]
    seen = [statistics.median(values[e - 5:e]) /
            statistics.median(values[e - 25:e - 5]) for e in ends if e >= 25]
    steps = [s for s, _, _ in rows]
    boundary = next(i for i, s in enumerate(steps) if s % 128 == 0) \
        if any(s % 128 == 0 for s in steps) else None
    post = None if boundary is None else max(
        statistics.median(values[i:i + 5])
        for i in range(boundary + 1, boundary + 28)) / median
    return {'steps': len(values), 'median_ms': round(median, 3),
            'post_save': None if post is None else round(post, 3),
            'seen_max': round(max(seen), 3) if seen else None,
            'seen_over_2': sum(r > 2 for r in seen)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--a', default=None, help='checkout A')
    parser.add_argument('--b', default=HERE, help='checkout B')
    parser.add_argument('--order', default='abba')
    parser.add_argument('--out', default=os.path.join(
        HERE, 'build', 'step_contention'))
    parser.add_argument('--phase', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.phase:
        return run_phase(args.phase)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, MLCOMP_TPU_TORCH_BUILD=os.path.join(
        HERE, 'build', 'torch_kernels'))
    runs = []
    for i, which in enumerate(args.order):
        checkout = os.path.abspath(getattr(args, which))
        db = os.path.join(out, f'{i}_{which}.sqlite')
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        '--phase', db], cwd=checkout, env=env, check=False)
        conn = sqlite3.connect(db)
        alerts = [r[0] for r in conn.execute(
            'SELECT rule FROM alert ORDER BY id')]
        conn.close()
        run = {'run': i, 'checkout': which,
               'attempts': [summarise(a) for a in attempts(db)],
               'alerts': alerts}
        print('[contention]', json.dumps(run), flush=True)
        runs.append(run)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    with open(os.path.join(out, 'summary.json'), 'w') as fh:
        json.dump({'card': smi.strip(), 'runs': runs}, fh, indent=1)


if __name__ == '__main__':
    main()
