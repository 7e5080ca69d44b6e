"""Thread fan-out helpers (reference: skyplane/utils/fn.py:17-63)."""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, Iterable, List, Optional, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def wait_for(
    fn: Callable[[], bool],
    timeout: float = 60.0,
    interval: float = 0.25,
    desc: str = "",
) -> None:
    """Block until ``fn()`` is truthy or raise TimeoutError after ``timeout`` seconds."""
    deadline = time.time() + timeout
    while True:
        if fn():
            return
        if time.time() >= deadline:
            raise TimeoutError(f"wait_for timeout ({timeout}s){': ' + desc if desc else ''}")
        time.sleep(interval)


def do_parallel(
    func: Callable[[T], R],
    args_list: Iterable[T],
    n: int = 32,
    desc: Optional[str] = None,
    return_args: bool = True,
    spinner: bool = False,
) -> List[Tuple[T, R]]:
    """Run ``func`` over ``args_list`` with a bounded thread pool.

    Returns ``[(arg, result), ...]`` in completion order (reference returns the
    same pairing). The first raised exception propagates after all futures
    settle; ``spinner`` draws a rich status line when a TTY is attached.
    """
    args_list = list(args_list)
    if not args_list:
        return []
    results: List[Tuple[T, R]] = []

    def run(arg: T) -> Tuple[T, R]:
        return arg, func(arg)

    status_ctx = None
    if spinner and desc:
        try:
            from rich.console import Console

            status_ctx = Console().status(desc)
        except Exception:
            status_ctx = None

    with ThreadPoolExecutor(max_workers=n) as pool:
        futures = {pool.submit(run, arg): arg for arg in args_list}
        first_exc: Optional[BaseException] = None
        if status_ctx is not None:
            status_ctx.__enter__()
        try:
            for fut in as_completed(futures):
                try:
                    results.append(fut.result())
                except BaseException as e:  # noqa: BLE001  # sklint: disable=bare-except-in-loop -- first_exc is re-raised after the drain loop
                    if first_exc is None:
                        first_exc = e
        finally:
            if status_ctx is not None:
                status_ctx.__exit__(None, None, None)
        if first_exc is not None:
            raise first_exc
    if return_args:
        return results
    return [r for _, r in results]  # type: ignore[return-value]
