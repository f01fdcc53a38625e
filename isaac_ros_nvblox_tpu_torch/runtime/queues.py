"""Thread-safe drop-oldest input queues + on-thread service task queue.

Reference: nvblox_ros's mutex-guarded input queues with drop-oldest at
`maximum_input_queue_length` and drop accounting
(nvblox_node.hpp:520-527, impl/nvblox_node_impl.hpp:33-102), and the
promise/future `ServiceRequestTask` marshalling service work onto the
processing thread (service_request_task.hpp:48-75).

A copy of isaac_ros_nvblox_tpu/runtime/queues.py for the port.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading
from typing import Callable, Deque, Generic, List, Tuple, TypeVar

T = TypeVar("T")


class DropOldestQueue(Generic[T]):
    def __init__(self, name: str, max_length: int = 10):
        self.name = name
        self.max_length = max_length
        self._dq: Deque[T] = collections.deque()
        self._lock = threading.Lock()
        self.dropped_count = 0

    def push(self, item: T) -> None:
        with self._lock:
            self._dq.append(item)
            while len(self._dq) > self.max_length:
                self._dq.popleft()
                self.dropped_count += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def extract_ready(self, ready_fn: Callable[[T], bool],
                      keep_unready: bool = True) -> List[T]:
        """Pop items whose `ready_fn` is true (pose resolvable); items that
        are not ready stay queued (parity: processQueue ready-check,
        impl/nvblox_node_impl.hpp:33-65)."""
        with self._lock:
            ready, rest = [], collections.deque()
            for item in self._dq:
                (ready if ready_fn(item) else rest).append(item)
            self._dq = rest if keep_unready else collections.deque()
            return ready

    def extract_all(self) -> List[T]:
        with self._lock:
            items = list(self._dq)
            self._dq.clear()
            return items


class ServiceRequestQueue:
    """Queue of callables executed on the tick thread; callers block on the
    returned future (parity: ServiceRequestTask + \
processServiceRequestTaskQueue, nvblox_node.cpp:748-772)."""

    def __init__(self):
        self._tasks: Deque[Tuple[Callable, concurrent.futures.Future]] = \
            collections.deque()
        self._lock = threading.Lock()

    def submit(self, fn: Callable) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            self._tasks.append((fn, fut))
        return fut

    def process_all(self) -> int:
        n = 0
        while True:
            with self._lock:
                if not self._tasks:
                    return n
                fn, fut = self._tasks.popleft()
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — report to caller
                fut.set_exception(e)
            n += 1
