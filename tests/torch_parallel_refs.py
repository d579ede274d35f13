"""The JAX package's reference values of the multi-rank tests, computed
ahead in worker threads.

A test module registers its reference computations (`References.reference`)
in the order its tests run. Once the module's rank pool starts
(`References.start`), worker threads compute them one after another, so
the JAX package's work overlaps the tests' waits for their ranks and each
other. Calling a registered reference returns its value: it waits for the
worker that took it, or computes it in the calling thread when no worker
has (a test run alone). `memo` shares one value between references (a
space or an operator several of them read). Imports no JAX.
"""
import functools
import threading
from concurrent.futures import Future

# JAX traces under the GIL and compiles outside it: two threads took
# test_torch_parallel.py from 70.7 to 57.2 s on an 8-core CPU box, a third
# to 57.6 s
WORKERS = 2


class References:
    def __init__(self):
        self._jobs = []                 # (key, fn, args), in test order
        self._futures = {}              # key -> Future, once taken
        self._lock = threading.Lock()
        self._threads = []
        self._next = 0
        self._stop = False

    def reference(self, *arg_sets):
        """Register fn once for each argument tuple (none: fn())."""
        def deco(fn):
            for args in arg_sets or ((),):
                self._jobs.append(((fn, tuple(args)), fn, tuple(args)))
            return self._caller(fn)
        return deco

    def memo(self, fn):
        """fn(*args) computed once per args, by whichever thread asks first."""
        return self._caller(fn)

    def _caller(self, fn):
        @functools.wraps(fn)
        def call(*args):
            return self._get((fn, args), fn, args)
        return call

    def _get(self, key, fn, args):
        with self._lock:
            fut = self._futures.get(key)
            mine = fut is None
            if mine:
                fut = self._futures[key] = Future()
        if mine:
            self._run(fut, fn, args)
        return fut.result()

    @staticmethod
    def _run(fut, fn, args):
        try:
            fut.set_result(fn(*args))
        except BaseException as e:          # the test that asks raises it
            fut.set_exception(e)

    def _work(self):
        while True:
            with self._lock:
                while (self._next < len(self._jobs)
                       and self._jobs[self._next][0] in self._futures):
                    self._next += 1
                if self._stop or self._next == len(self._jobs):
                    return
                key, fn, args = self._jobs[self._next]
                fut = self._futures[key] = Future()
                self._next += 1
            self._run(fut, fn, args)

    def start(self):
        self._stop = False
        self._threads = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(WORKERS)]
        for t in self._threads:
            t.start()

    def stop(self):
        """Take no further job; wait for the ones running."""
        with self._lock:
            self._stop = True
        for t in self._threads:
            t.join()
        self._threads = []
