"""Estimate how often the tier-1 run's xdist split strands a cluster.

`tests/test_runtime_env.py::ensure_cluster` starts a cluster when none is
up and never shuts it down; only the module's `cluster` fixture teardown
does. Under `pytest -n 6 --dist load` the module's tests are handed out in
contiguous chunks, and a worker that runs an `ensure_cluster` test without
holding the `cluster` fixture keeps the cluster up: every later
`ray_tpu.init()` on that worker raises "already called". Which worker gets
which chunk follows the test count (the first chunks are count // 24 long)
and the test durations, so adding or removing tests anywhere moves the
split.

A second hazard follows the split the same way:
`tests/test_serve.py::test_push_config_propagation_no_polling` asserts
that the serve config watcher is running after one handle call, but a
handle starts it only on its second call; it passes only when
`test_multiple_replicas_balanced` ran before it in the same module
session on its worker (a whole run at 1600 collected tests failed it).

This replays pytest-xdist's LoadScheduling on a collection with the
durations of an earlier run (each jittered at random per trial) and counts
the trials in which a worker is left with the cluster up (`stranded`) and
those in which the push test runs without its starter (`push_fails`):

    python -m pytest tests/ -q -m 'not slow' --collect-only > collect.txt
    python scripts/xdist_split.py collect.txt run.xml --scan -30 30 3

`run.xml` is the `--junitxml` of a whole run. `--scan LO HI STEP` adds
(or, below 0, removes) that many tests at the end of the collection, to
show which counts are clear of the hazard.
"""

import argparse
import heapq
import random
import xml.etree.ElementTree as ET

MODULE = "tests/test_runtime_env.py"
# Offsets within MODULE: tests on the `cluster` fixture, tests that shut
# the cluster down, tests on `ensure_cluster`.
CLUSTER_TESTS, SHUTDOWN_TESTS, ENSURE_TESTS = range(5), (5, 7), (10, 12)


def load(collect_path, junit_path):
    items = [line.strip() for line in open(collect_path) if "::" in line]
    durations = {}
    for case in ET.parse(junit_path).iter("testcase"):
        path = case.get("classname").replace(".", "/") + ".py"
        durations[f"{path}::{case.get('name')}"] = float(case.get("time"))
    return items, [durations.get(item, 0.05) for item in items]


def schedule(durations, workers, jitter, rng):
    """Per worker, the collection indices it ran, in order (xdist 3.x
    LoadScheduling; a worker runs a test only once it holds the next one,
    or once the controller has nothing left to send)."""
    n = len(durations)
    took = [d * (1 + rng.uniform(-jitter, jitter)) for d in durations]
    pending = list(range(n))
    queue = {w: [] for w in range(workers)}
    ran = {w: [] for w in range(workers)}
    busy = dict.fromkeys(range(workers), False)
    events = []

    def send(w, count):
        queue[w].extend(pending[:count])
        del pending[:count]

    def start(w, now):
        if busy[w] or not queue[w] or (len(queue[w]) < 2 and pending):
            return
        busy[w] = True
        item = queue[w][0]
        heapq.heappush(events, (now + took[item] + 0.01 * rng.random(), w,
                                item))

    for w in range(workers):
        send(w, max(n // workers // 4, 2))
    for w in range(workers):
        start(w, 0.0)
    while events:
        now, w, item = heapq.heappop(events)
        busy[w] = False
        queue[w].remove(item)
        ran[w].append(item)
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            if (len(queue[w]) < low
                    and not (took[item] >= 0.1 and len(queue[w]) >= 2)):
                send(w, high - len(queue[w]))
        for v in range(workers):
            start(v, now)
    return ran


def stranded(items, ran):
    """Workers that leave MODULE with a cluster up."""
    first = next(i for i, item in enumerate(items)
                 if item.startswith(MODULE + "::"))
    out = []
    for w, order in ran.items():
        fixture = up = False
        prev = None
        for item in order + [None]:
            module = None if item is None else items[item].split("::")[0]
            if prev == MODULE and module != MODULE:
                if fixture:
                    fixture = up = False
                if up:
                    out.append(w)
            prev = module
            if module != MODULE:
                continue
            offset = item - first
            if offset in CLUSTER_TESTS and not fixture:
                fixture = up = True
            elif offset in SHUTDOWN_TESTS:
                up = False
            elif offset in ENSURE_TESTS:
                up = True
    return out


PUSH = "tests/test_serve.py::test_push_config_propagation_no_polling"
PUSH_STARTER = "tests/test_serve.py::test_multiple_replicas_balanced"


def push_fails(items, ran):
    """True when the push test's worker did not run PUSH_STARTER earlier
    in the same stretch of tests/test_serve.py (another module's test in
    between tears the module's cluster and its watcher down)."""
    for order in ran.values():
        started, prev = False, None
        for item in order:
            module = items[item].split("::")[0]
            if module != prev:
                started, prev = False, module
            if items[item] == PUSH_STARTER:
                started = True
            elif items[item] == PUSH:
                return not started
    return False


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("collect")
    ap.add_argument("junit")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--trials", type=int, default=300)
    ap.add_argument("--jitter", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scan", type=int, nargs=3, metavar=("LO", "HI", "STEP"))
    args = ap.parse_args()
    items, durations = load(args.collect, args.junit)
    deltas = range(*args.scan) if args.scan else [0]
    print("tests  first_chunk  stranded_trials  push_fails")
    for delta in deltas:
        if delta >= 0:
            its = items + [f"tests/test_added.py::t{j}" for j in range(delta)]
            dus = durations + [0.5] * delta
        else:
            its, dus = items[:delta], durations[:delta]
        rng = random.Random(args.seed)
        hits = push = 0
        for _ in range(args.trials):
            ran = schedule(dus, args.workers, args.jitter, rng)
            hits += bool(stranded(its, ran))
            push += push_fails(its, ran)
        print(f"{len(its):5d}  {len(its) // args.workers // 4:11d}  "
              f"{hits}/{args.trials}  {push}/{args.trials}")


if __name__ == "__main__":
    main()
