"""Seeded thread-shared-state violations.

Mutation fixture for tests/test_torch_lint.py: an attribute written from
a worker pool, a named thread and the main thread with no lock (CEP-T01),
and an executor whose workers are anonymous (CEP-T03). NOT runnable
production code.
"""
import concurrent.futures
import threading


class LeakyPool:
    def __init__(self) -> None:
        self.counter = 0
        self.ok = 0
        self._lock = threading.Lock()
        self._pool = None

    def start(self) -> None:
        # CEP-T03: no thread_name_prefix.
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pool.submit(self._job)
        threading.Thread(target=self._job, name="fixture-job", daemon=True).start()

    def _job(self) -> None:
        self.counter += 1            # CEP-T01: also written from main
        with self._lock:
            self.ok += 1             # guarded everywhere: clean

    def bump(self) -> None:
        self.counter += 1            # CEP-T01: main-root write, no lock
        with self._lock:
            self.ok += 1
