"""Unified logging: console + file + wandb + progress + metrics.

A copy of ``sdxl_training_improvements_tpu/core/logging.py`` (numpy and the
standard library; the default logger is named ``sdxl_torch`` so the
two packages' loggers stay apart in one process), plus one line per
``log_metrics`` call in the log file (``metrics step=N {json}``, DEBUG),
and, in a ``torch.distributed`` process group, warnings only from the
ranks above 0.
Functional counterpart of the reference logging stack (``src/core/logging/``
— ``UnifiedLogger``/``LogManager`` ``core.py:17-333``, ``WandbLogger``
``wandb.py:67-322``, ``MetricsTracker`` ``metrics.py``, ``ProgressPredictor``
``progress_predictor.py``, colored formatter ``formatters.py``), preserving
the API surface BASELINE.json calls out: ``log_metrics(dict, step)``,
``log_images``, metric prefixing, progress/ETA, plus ``setup_logging`` /
``get_logger`` / ``cleanup_logging`` module functions.

wandb is an optional dependency: when missing, the wandb sink degrades to a
no-op and everything else keeps working.
"""
from __future__ import annotations

import json
import logging
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist

# ---------------------------------------------------------------- config

@dataclass
class LogConfig:
    """Reference ``LogConfig`` surface (``logging/base.py:6-44``)."""

    name: str = "sdxl_torch"
    log_dir: str = "logs"
    filename: str = "training.log"
    console_level: str = "INFO"
    file_level: str = "DEBUG"
    capture_warnings: bool = True
    use_wandb: bool = False
    wandb_project: str = "sdxl-training"
    wandb_entity: Optional[str] = None
    wandb_run_name: Optional[str] = None
    log_every: int = 10
    metrics_window: int = 100


def _json_value(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


# ------------------------------------------------------------- formatter

_COLORS = {"DEBUG": "\x1b[36m", "INFO": "\x1b[32m", "WARNING": "\x1b[33m",
           "ERROR": "\x1b[31m", "CRITICAL": "\x1b[41m"}
_RESET = "\x1b[0m"
_KEYWORDS = {"Starting": "\x1b[35m", "Complete": "\x1b[32m",
             "Error": "\x1b[31m", "Failed": "\x1b[31m", "Saving": "\x1b[34m"}


class ColoredFormatter(logging.Formatter):
    """ANSI level colors + keyword highlighting (``formatters.py:12-70``)."""

    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        if color and sys.stderr.isatty():
            for kw, kc in _KEYWORDS.items():
                if kw in msg:
                    msg = msg.replace(kw, f"{kc}{kw}{_RESET}{color}")
            msg = f"{color}{msg}{_RESET}"
        return msg


# --------------------------------------------------------------- metrics

class MetricsTracker:
    """Thread-safe windowed metric averages (``metrics.py:8-51``)."""

    def __init__(self, window_size: int = 100, keep_history: bool = False):
        self.window_size = window_size
        self.keep_history = keep_history
        self._lock = threading.Lock()
        self._values: Dict[str, deque] = {}
        self._history: Dict[str, List[float]] = {}

    def update(self, name: str, value: float) -> None:
        with self._lock:
            self._values.setdefault(
                name, deque(maxlen=self.window_size)).append(float(value))
            if self.keep_history:
                self._history.setdefault(name, []).append(float(value))

    def update_many(self, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            try:
                self.update(k, float(v))
            except (TypeError, ValueError):
                pass

    def get_average(self, name: str) -> Optional[float]:
        with self._lock:
            vals = self._values.get(name)
            return float(np.mean(vals)) if vals else None

    def get_all_averages(self) -> Dict[str, float]:
        with self._lock:
            return {k: float(np.mean(v)) for k, v in self._values.items() if v}

    def get_history(self, name: str) -> List[float]:
        with self._lock:
            return list(self._history.get(name, []))


class ProgressPredictor:
    """Dual moving-window ETA: short window weighted 0.7, long 0.3
    (``progress_predictor.py:36-96``)."""

    def __init__(self, short_window: int = 10, long_window: int = 100):
        self.short = deque(maxlen=short_window)
        self.long = deque(maxlen=long_window)
        self._last: Optional[float] = None

    def update(self, n: int = 1) -> None:
        now = time.monotonic()
        if self._last is not None and n > 0:
            per_item = (now - self._last) / n
            self.short.append(per_item)
            self.long.append(per_item)
        self._last = now

    def eta_seconds(self, remaining: int) -> Optional[float]:
        if not self.short:
            return None
        s = float(np.mean(self.short))
        l = float(np.mean(self.long)) if self.long else s
        return remaining * (0.7 * s + 0.3 * l)

    @staticmethod
    def format_time(seconds: Optional[float]) -> str:
        if seconds is None:
            return "??"
        seconds = int(seconds)
        h, rem = divmod(seconds, 3600)
        m, s = divmod(rem, 60)
        return f"{h}h{m:02d}m{s:02d}s" if h else (f"{m}m{s:02d}s" if m
                                                  else f"{s}s")


class ProgressTracker:
    """tqdm wrapper with windowed samples/sec (reference ``progress.py``);
    degrades to counters when tqdm is unavailable or disabled."""

    def __init__(self, total: Optional[int] = None, desc: str = "train",
                 batch_size: int = 1, window: int = 50, enable: bool = True):
        self.batch_size = batch_size
        self.times: deque = deque(maxlen=window)
        self._last = time.monotonic()
        self.count = 0
        self._bar = None
        if enable:
            try:
                from tqdm import tqdm
                self._bar = tqdm(total=total, desc=desc, dynamic_ncols=True)
            except Exception:
                pass

    def update(self, n: int = 1, **postfix) -> None:
        now = time.monotonic()
        self.times.append((now - self._last) / max(n, 1))
        self._last = now
        self.count += n
        if self._bar is not None:
            if postfix:
                self._bar.set_postfix(postfix, refresh=False)
            self._bar.update(n)

    def get_metrics(self) -> Dict[str, float]:
        if not self.times:
            return {}
        per_step = float(np.mean(self.times))
        return {"progress/samples_per_sec": self.batch_size / per_step,
                "progress/steps_per_sec": 1.0 / per_step}

    def close(self) -> None:
        if self._bar is not None:
            self._bar.close()


# ----------------------------------------------------------------- wandb

class WandbLogger:
    """wandb sink with metric prefixing + image logging
    (``wandb.py:67-322``); silently no-ops when wandb is unavailable."""

    def __init__(self, project: str = "sdxl-training",
                 entity: Optional[str] = None, name: Optional[str] = None,
                 config: Optional[dict] = None, prefix: str = "",
                 max_images_to_log: int = 16, resume: bool = True):
        self.prefix = prefix
        self.max_images = max_images_to_log
        self._run = None
        try:
            import wandb
        except ImportError:
            self._wandb = None  # not installed: documented silent no-op
            return
        self._wandb = wandb
        try:
            self._run = wandb.init(project=project, entity=entity, name=name,
                                   config=config,
                                   resume="allow" if resume else None)
        except Exception as e:
            # the user ASKED for wandb; a dead run must not be silent
            logging.getLogger(__name__).warning(
                "wandb.init failed (%s): metrics will NOT reach wandb "
                "for this run", e)

    @property
    def active(self) -> bool:
        return self._run is not None

    def _key(self, k: str) -> str:
        return f"{self.prefix}/{k}" if self.prefix else k

    def log_metrics(self, metrics: Dict[str, Any],
                    step: Optional[int] = None) -> None:
        if not self.active:
            return
        payload = {}
        for k, v in metrics.items():
            try:
                payload[self._key(k)] = float(v)
            except (TypeError, ValueError):
                payload[self._key(k)] = v
        self._run.log(payload, step=step)

    def log_images(self, images: Dict[str, Any],
                   step: Optional[int] = None) -> None:
        """PIL/np arrays -> wandb.Image, capped at max_images
        (``wandb.py:195-244``)."""
        if not self.active:
            return
        payload = {}
        for k, v in list(images.items())[: self.max_images]:
            payload[self._key(k)] = self._wandb.Image(v)
        self._run.log(payload, step=step)

    def log_config(self, config: dict) -> None:
        if self.active:
            self._run.config.update(config, allow_val_change=True)

    def log_model(self, path, name: str = "model") -> None:
        if not self.active:
            return
        art = self._wandb.Artifact(name, type="model")
        art.add_dir(str(path))
        self._run.log_artifact(art)

    def finish(self) -> None:
        if self.active:
            self._run.finish()
            self._run = None


class NullWandb(WandbLogger):
    """Inert WandbLogger: same surface, never initialises a run."""

    def __init__(self, prefix: str = "", max_images_to_log: int = 16):
        self.prefix = prefix
        self.max_images = max_images_to_log
        self._run = None
        self._wandb = None


# --------------------------------------------------------------- unified

class UnifiedLogger:
    """Console + file + wandb + metrics + progress facade
    (``core.py:68-333``)."""

    def __init__(self, config: Optional[LogConfig] = None):
        self.config = config or LogConfig()
        self.logger = logging.getLogger(self.config.name)
        self.logger.setLevel(logging.DEBUG)
        self.logger.handlers.clear()
        self.logger.propagate = False

        # above rank 0 the console shows warnings and errors only, and no
        # log file or wandb run is written (rank 0 keeps them)
        rank = dist.get_rank() if dist.is_initialized() else 0
        main = rank == 0
        console = logging.StreamHandler(sys.stderr)
        level = logging.getLevelName(self.config.console_level.upper())
        console.setLevel(level if main else max(level, logging.WARNING))
        console.setFormatter(ColoredFormatter(
            (f"rank {rank} | " if not main else "")
            + "%(asctime)s | %(levelname)s | %(message)s", "%H:%M:%S"))
        self.logger.addHandler(console)

        log_dir = Path(self.config.log_dir)
        try:
            if main:
                log_dir.mkdir(parents=True, exist_ok=True)
                fh = logging.FileHandler(log_dir / self.config.filename)
                fh.setLevel(self.config.file_level.upper())
                fh.setFormatter(logging.Formatter(
                    "%(asctime)s | %(name)s | %(levelname)s | %(message)s"))
                self.logger.addHandler(fh)
        except OSError:
            pass

        if self.config.capture_warnings:
            logging.captureWarnings(True)

        self.metrics = MetricsTracker(self.config.metrics_window)
        self.predictor = ProgressPredictor()
        self.progress = ProgressTracker(enable=False)  # windowed step rate
        self.wandb = (WandbLogger(self.config.wandb_project,
                                  self.config.wandb_entity,
                                  self.config.wandb_run_name)
                      if self.config.use_wandb and main else NullWandb())

    # standard logger passthrough
    def debug(self, msg, *a, **k): self.logger.debug(msg, *a, **k)
    def info(self, msg, *a, **k): self.logger.info(msg, *a, **k)
    def warning(self, msg, *a, **k): self.logger.warning(msg, *a, **k)
    def error(self, msg, *a, **k): self.logger.error(msg, *a, **k)

    def log_metrics(self, metrics: Dict[str, Any],
                    step: Optional[int] = None) -> None:
        self.metrics.update_many(metrics)
        self.wandb.log_metrics(metrics, step=step)
        self.debug(f"metrics step={step} "
                   f"{json.dumps(metrics, default=_json_value)}")

    def log_images(self, images: Dict[str, Any],
                   step: Optional[int] = None) -> None:
        self.wandb.log_images(images, step=step)

    def update_progress(self, current: int, total: int = 0, n: int = 1,
                        extra: str = "") -> None:
        self.predictor.update(n)
        self.progress.update(n)
        if current % max(self.config.log_every, 1) == 0 or current == total:
            avg = self.metrics.get_average("loss")
            loss_s = f" loss={avg:.4f}" if avg is not None else ""
            if total > current:
                eta = self.predictor.eta_seconds(total - current)
                head = (f"step {current}/{total}{loss_s} "
                        f"eta={ProgressPredictor.format_time(eta)}")
            else:
                head = f"step {current}{loss_s}"
            self.info(f"{head} {extra}".rstrip())

    def finish(self) -> None:
        self.wandb.finish()
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)


# ------------------------------------------------------------ module API

class LogManager:
    """Thread-safe singleton registry (``core.py:17-66``)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self.loggers: Dict[str, UnifiedLogger] = {}

    @classmethod
    def instance(cls) -> "LogManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def get(self, name: str, config: Optional[LogConfig] = None
            ) -> UnifiedLogger:
        # UnifiedLogger construction can run wandb.init (network calls with
        # retries) — it must NOT happen under the class-wide lock or every
        # other thread's get_logger/setup_logging blocks for the duration.
        # Protocol: reserve the name under the lock with an Event, build
        # outside it, publish under the lock; concurrent callers for the
        # same name wait on the Event.
        while True:
            with self._lock:
                entry = self.loggers.get(name)
                if isinstance(entry, UnifiedLogger):
                    if config is not None and config != entry.config:
                        entry.warning(
                            f"setup_logging({name!r}): logger already "
                            "exists; the new LogConfig is IGNORED "
                            "(wandb/log_dir/levels keep their original "
                            "values). Call cleanup_logging() first to "
                            "reconfigure.")
                    return entry
                if entry is None:
                    reservation = threading.Event()
                    self.loggers[name] = reservation
                    break
            entry.wait()  # another thread is constructing this name
        try:
            cfg = config or LogConfig(name=name)
            cfg.name = name
            built = UnifiedLogger(cfg)
        except BaseException:
            with self._lock:  # release the reservation; waiters retry
                if self.loggers.get(name) is reservation:
                    del self.loggers[name]
            reservation.set()
            raise
        with self._lock:
            self.loggers[name] = built
        reservation.set()
        return built

    def cleanup(self) -> None:
        # snapshot/remove built loggers under the lock (a concurrent get()
        # may publish mid-iteration); KEEP in-flight reservations so their
        # builder publishes into the surviving slot rather than
        # resurrecting a logger cleanup never saw (that logger is then
        # simply newer than this cleanup).  finish() — wandb teardown,
        # network — runs outside the lock.
        with self._lock:
            built = [lg for lg in self.loggers.values()
                     if isinstance(lg, UnifiedLogger)]
            self.loggers = {name: lg for name, lg in self.loggers.items()
                            if not isinstance(lg, UnifiedLogger)}
        for lg in built:
            lg.finish()


def setup_logging(config: Optional[LogConfig] = None,
                  name: str = "sdxl_torch") -> UnifiedLogger:
    return LogManager.instance().get(name, config)


def get_logger(name: str = "sdxl_torch") -> UnifiedLogger:
    return LogManager.instance().get(name)


def cleanup_logging() -> None:
    LogManager.instance().cleanup()
