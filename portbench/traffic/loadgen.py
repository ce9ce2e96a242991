"""The load generator of a served cell: host ranks in a process apart
from the server's, one connection each, in a closed loop.

    python3 portbench/traffic/loadgen.py --port P --clients 8 --chunk 384
        --chunks-per-client 4 --layout v4 --seed S --keep 8 --out F.npz

Each client is a host rank of a coupled run: it holds its own chunks of
raw columns, drawn from ``--seed`` by the frozen generator (client c's
chunk k is rows (c*K + k)*chunk onwards of one draw, which the harness
repeats for the reference), and sends them in turn, one a physics step.
The ranks step together, as a coupled run's do (the dynamical core's
halo exchange joins them every step): a step starts when the last rank
of the step before has its reply, and then every rank sends its request
at once.  No rate is set: the loop runs as fast as the server answers,
and every seed offers the same sizes.  A request is due when its step
starts; its round trip is timed from then to its reply.  The process
connects, sends each client's first chunk once (set-up), prints
``ready`` and waits for a line ``go <seconds>`` on its standard input.
Then the ranks step until a step would start after ``seconds``, and the
process writes ``--out``: for every request its client, chunk, due,
send and reply times in seconds from ``go`` and whether it was
answered; and the replies of a sample drawn from the seed (``--keep`` a
client, reservoir sampling over all its requests, plus its first).  It
prints ``done``.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.traffic.synthetic import synthetic_inputs  # noqa: E402
from portbench.traffic.varspec import Layout  # noqa: E402
from portbench.traffic.wire import Client, WireError, frame  # noqa: E402


def client_chunks(layout: str, clients: int, per_client: int, chunk: int,
                  seed: int) -> np.ndarray:
    """(clients, per_client, chunk, features) raw float32 columns."""
    x = synthetic_inputs(Layout(layout), clients * per_client * chunk, seed)
    return x.reshape(clients, per_client, chunk, -1)


class _Steps:
    """The ranks' shared clock: a barrier whose action, run once all the
    ranks are in, starts the next step or ends the loop."""

    def __init__(self, clients: int, t0: float, seconds: float):
        self.t0, self.seconds = t0, seconds
        self.due, self.over = 0.0, False
        self.barrier = threading.Barrier(clients, action=self._next)

    def _next(self) -> None:
        self.due = time.perf_counter() - self.t0
        self.over = self.due >= self.seconds


class _Run:
    """One rank's loop and its records."""

    def __init__(self, index: int, client: Client, frames: list, keep: int,
                 seed: int):
        self.index, self.client, self.frames = index, client, frames
        self.keep = keep
        self.rng = np.random.default_rng([seed, index])
        self.records: list = []        # (chunk, due, t_send, t_recv, ok)
        self.kept: dict = {}           # request index -> (chunk, reply)

    def loop(self, steps: _Steps) -> None:
        i = 0
        while True:
            try:
                steps.barrier.wait()
            except threading.BrokenBarrierError:
                return        # another rank lost its connection
            if steps.over:
                return
            due, t0 = steps.due, steps.t0
            t_send = time.perf_counter() - t0
            k = i % len(self.frames)
            try:
                self.client.send(self.frames[k])
                reply = self.client.recv()
            except (WireError, OSError):
                self.records.append((k, due, t_send, np.inf, False))
                steps.barrier.abort()
                return        # the connection is gone: no further request
            self.records.append((k, due, t_send, time.perf_counter() - t0,
                                 True))
            self._sample(i, k, reply)
            i += 1

    def _sample(self, i: int, k: int, reply: np.ndarray) -> None:
        """The first reply, and a reservoir of ``keep`` of the rest."""
        if i == 0:
            self.kept[0] = (k, reply)
            return
        others = [j for j in self.kept if j != 0]
        if len(others) < self.keep:
            self.kept[i] = (k, reply)
            return
        j = int(self.rng.integers(0, i))    # i requests after the first
        if j < self.keep:
            del self.kept[sorted(others)[j]]
            self.kept[i] = (k, reply)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--clients", type=int, required=True)
    ap.add_argument("--chunk", type=int, required=True)
    ap.add_argument("--chunks-per-client", type=int, required=True)
    ap.add_argument("--layout", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--keep", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    chunks = client_chunks(args.layout, args.clients, args.chunks_per_client,
                           args.chunk, args.seed)
    runs = [_Run(c, Client(args.host, args.port),
                 [frame(x) for x in chunks[c]], args.keep, args.seed)
            for c in range(args.clients)]

    def warm(r):
        r.client.send(r.frames[0])
        r.client.recv()

    threads = [threading.Thread(target=warm, args=(r,)) for r in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if len(line) != 2 or line[0] != "go":
        print(f"loadgen: want 'go <seconds>', got {line}", file=sys.stderr)
        return 2
    steps = _Steps(args.clients, time.perf_counter(), float(line[1]))
    threads = [threading.Thread(target=r.loop, args=(steps,)) for r in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in runs:
        r.client.close()

    rec = [(r.index, *x) for r in runs for x in r.records]
    kept = [(r.index, i, k, y) for r in runs for i, (k, y)
            in sorted(r.kept.items())]
    np.savez(args.out,
             client=np.array([x[0] for x in rec], np.int64),
             chunk=np.array([x[1] for x in rec], np.int64),
             due=np.array([x[2] for x in rec], np.float64),
             t_send=np.array([x[3] for x in rec], np.float64),
             t_recv=np.array([x[4] for x in rec], np.float64),
             ok=np.array([x[5] for x in rec], bool),
             kept_client=np.array([x[0] for x in kept], np.int64),
             kept_index=np.array([x[1] for x in kept], np.int64),
             kept_chunk=np.array([x[2] for x in kept], np.int64),
             kept_reply=(np.stack([x[3] for x in kept]) if kept
                         else np.zeros((0, 0, 0), np.float32)))
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
