"""Leveled logger and a device-honest timer.

Counterpart of `spateo_tpu.logging`: the same `Logger` and `LoggerManager`
methods (`Logger.log_time` is a host timestamp, as there), the module's
`log_time`, which waits for the card (`torch.cuda.synchronize()`) where the
JAX package waited on `jax.effects_barrier()`, and the helpers `timeit`,
`silence_logger`, `set_logger_level` and `format_logging_message`, copied.
"""

from __future__ import annotations

import functools
import logging
import sys
import time
from contextlib import contextmanager
from typing import Optional

import torch


class Logger:
    FORMAT = "|-----> %(message)s"

    def __init__(self, namespace: str = "spateo", level: Optional[int] = None):
        self.namespace = namespace
        self.logger = logging.getLogger(namespace)
        self.previous_timestamp = time.time()
        self.time_passed = 0.0
        if not self.logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(self.FORMAT))
            self.logger.addHandler(handler)
        self.logger.propagate = False
        self.logger.setLevel(logging.INFO if level is None else level)

    @property
    def level(self):
        return self.logger.level

    def namespaced(self, namespace: str) -> "Logger":
        return Logger(f"{self.namespace}.{namespace}", level=self.logger.level)

    def setLevel(self, level):
        self.logger.setLevel(level)

    def debug(self, msg, *args, **kwargs):
        self.logger.debug(msg, *args, **kwargs)

    def info(self, msg, *args, **kwargs):
        self.logger.info(msg, *args, **kwargs)

    def warning(self, msg, *args, **kwargs):
        self.logger.warning(msg, *args, **kwargs)

    def error(self, msg, *args, **kwargs):
        self.logger.error(msg, *args, **kwargs)

    def critical(self, msg, *args, **kwargs):
        self.logger.critical(msg, *args, **kwargs)

    def log_time(self):
        """Seconds on the host's clock since the previous call (or since
        the logger was made); no wait for the card."""
        now = time.time()
        self.time_passed = now - self.previous_timestamp
        self.previous_timestamp = now
        return self.time_passed

    def report_progress(self, percent: Optional[float] = None, count: Optional[int] = None, total: Optional[int] = None, progress_name: str = ""):
        if percent is None and count is not None and total:
            percent = count / total * 100
        saved_terminator = None
        for h in self.logger.handlers:
            saved_terminator = getattr(h, "terminator", None)
            h.terminator = ""
        try:
            self.logger.info(f"\r|-----> {progress_name} [{percent:.1f}%]")
        finally:
            for h in self.logger.handlers:
                if saved_terminator is not None:
                    h.terminator = saved_terminator

    def finish_progress(self, progress_name: str = "", time_unit: str = "s", indent_level: int = 1):
        """Log the seconds (or, with `time_unit="ms"`, milliseconds) since
        the previous `log_time`."""
        self.log_time()
        t = self.time_passed if time_unit == "s" else self.time_passed * 1e3
        self.logger.info(f"{progress_name} finished [{t:.4f}{time_unit}]")


class LoggerManager:
    """The `lm.main_*` surface of the reference's logger."""

    DEBUG = logging.DEBUG
    INFO = logging.INFO
    WARNING = logging.WARNING
    ERROR = logging.ERROR
    CRITICAL = logging.CRITICAL

    def __init__(self, namespace: str = "spateo"):
        self.main_logger = Logger(namespace)
        self.temp_timer_logger = Logger(f"{namespace}-temp-timer-logger")

    def get_main_logger(self) -> Logger:
        return self.main_logger

    def gen_logger(self, namespace: str) -> Logger:
        return Logger(namespace, level=self.main_logger.level)

    def main_set_level(self, level):
        self.main_logger.setLevel(level)

    def main_info(self, msg, indent_level: int = 1):
        self.main_logger.info(msg)

    def main_debug(self, msg, indent_level: int = 1):
        self.main_logger.debug(msg)

    def main_warning(self, msg, indent_level: int = 1):
        self.main_logger.warning(msg)

    def main_error(self, msg, indent_level: int = 1):
        self.main_logger.error(msg)

    def main_critical(self, msg, indent_level: int = 1):
        self.main_logger.critical(msg)

    def main_exception(self, message, indent_level: int = 1):
        self.main_logger.logger.exception(message)

    def main_tqdm(self, generator=None, desc: str = "", indent_level: int = 1, logger=None, total: Optional[int] = None, iterable=None):
        """Iterate over `generator` (or `iterable`), logging `[i/total]` and
        the seconds so far every twentieth of `total`."""
        iterable = generator if generator is not None else iterable
        total = total if total is not None else (len(iterable) if hasattr(iterable, "__len__") else None)
        start = time.time()
        for i, item in enumerate(iterable):
            yield item
            if total and (i + 1) % max(1, total // 20) == 0:
                elapsed = time.time() - start
                self.main_logger.info(f"{desc} [{i + 1}/{total}] ({elapsed:.1f}s)")

    def progress_logger(self, generator, logger=None, progress_name: str = "", indent_level: int = 1):
        """Log the start and end (with seconds) of a loop over `generator`."""
        self.main_logger.info(f"<start> {progress_name}")
        t0 = time.time()
        for item in generator:
            yield item
        self.main_logger.info(f"<end> {progress_name} [{time.time() - t0:.4f}s]")

    def main_info_insert_adata(self, key, adata_attr: str = "obsm", indent_level: int = 1):
        self.main_debug(f"<insert> {key} to {adata_attr} in AnnData Object.")

    def main_info_insert_adata_var(self, key, indent_level: int = 1):
        self.main_info_insert_adata(key, "var")

    def main_info_insert_adata_obs(self, key, indent_level: int = 1):
        self.main_info_insert_adata(key, "obs")

    def main_info_insert_adata_obsm(self, key, indent_level: int = 1):
        self.main_info_insert_adata(key, "obsm")

    def main_info_insert_adata_uns(self, key, indent_level: int = 1):
        self.main_info_insert_adata(key, "uns")

    def main_info_insert_adata_layer(self, key, indent_level: int = 1):
        self.main_info_insert_adata(key, "layers")


logger_manager = LoggerManager()
lm = logger_manager


@contextmanager
def log_time(name: str, logger: Optional[Logger] = None, sync: bool = True):
    """Time a block. With `sync`, waits for queued CUDA work first, since
    PyTorch returns before the card has finished."""
    logger = logger or logger_manager.main_logger
    t0 = time.perf_counter()
    yield
    if sync and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    logger.info(f"{name}: {time.perf_counter() - t0:.4f}s")


def timeit(fn):
    """Wrap `fn` so that each call is timed by `log_time` under its name."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with log_time(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper


def silence_logger(name: str) -> None:
    """Silence a named stdlib logger completely (parity: reference
    external/lack.py:30)."""
    package_logger = logging.getLogger(name)
    package_logger.setLevel(logging.CRITICAL + 100)
    package_logger.propagate = False


def set_logger_level(name: str, level) -> None:
    """Set a named stdlib logger's level (parity: external/lack.py:41)."""
    logging.getLogger(name).setLevel(level)


def format_logging_message(msg, logging_level, indent_level: int = 1, indent_space_num: int = 6) -> str:
    """The lack arrow-prefix message format (parity: external/lack.py:51):
    ``|----->`` info, ``|-----?`` warning, ``|-----!!`` critical,
    ``|----->>>`` debug."""
    indent_str = "-" * indent_space_num
    prefix = indent_str * indent_level
    prefix = "|" + prefix[1:]
    if logging_level == logging.INFO:
        prefix += ">"
    elif logging_level == logging.WARNING:
        prefix += "?"
    elif logging_level == logging.CRITICAL:
        prefix += "!!"
    elif logging_level == logging.DEBUG:
        prefix += ">>>"
    return prefix + " " + str(msg)
