"""Experiment environment (port of `autognothi_tpu/pipeline/env.py`): the
directory, its config, the `.log.txt` it appends timestamped lines to, the
per-stage loggers (`fork`, `metrics`) and the config write-back
(`flush_cfg`).  wandb is optional: a stage whose logger block enables it
logs there when the `wandb` package is importable, and otherwise logs its
metrics as `METRICS:` lines, as the JAX package does without wandb.  In a
world of ranks (`parallel/distributed.py`) only rank 0 writes the log
file, the config and wandb; every rank prints its lines."""

from __future__ import annotations

import copy
import dataclasses
import datetime
import json
import pathlib
import threading
from typing import Any, Callable, Dict, Optional

from ..parallel.distributed import is_writer
from ..utils.strings import flatten_dict
from .config import LOGGERS, Config_Logger, ExpConfig, parse_config

# a stage's logger-options selector: the config -> its wandb block or None
LoggerOpts = Callable[[ExpConfig], Optional[Config_Logger]]


def _try_wandb():
    try:
        import wandb

        return wandb
    except ImportError:
        return None


class ExpEnv:
    def __init__(self, model_path: pathlib.Path,
                 get_logger_opts: LoggerOpts = lambda cfg: None,
                 _forked: Optional["ExpEnv"] = None) -> None:
        self.model_path = pathlib.Path(model_path)
        self._get_logger_opts = get_logger_opts
        if _forked is not None:  # shares the config and the log file
            self.config = _forked.config
            self._log_lock, self._log_fd = _forked._log_lock, _forked._log_fd
            self._owner = False
            return
        self.config: ExpConfig = parse_config(json.loads(
            (self.model_path / ".hparams.json").read_text("utf-8")))
        self._log_lock = threading.Lock()
        self._log_fd = (open(self.model_path / ".log.txt", "a",
                             encoding="utf-8") if is_writer() else None)
        self._owner = True
        self.log(f"[[[ NEW RUN: load config from "
                 f"{self.model_path.absolute().as_posix()} ]]]")

    def fork(self, get_logger_opts: LoggerOpts) -> "ExpEnv":
        """The same experiment with a stage's own logger options."""
        return ExpEnv(self.model_path, get_logger_opts, _forked=self)

    def log(self, msg: str) -> None:
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")
        line = f"[{ts}] {msg}"
        print(line, flush=True)
        with self._log_lock:
            if self._log_fd is not None and not self._log_fd.closed:
                self._log_fd.write(line + "\n")
                self._log_fd.flush()

    def _wandb(self):
        """-> (the stage's logger options, wandb) where wandb logs, else
        (options, None)."""
        opts = self._get_logger_opts(self.config)
        if opts is None or not opts.wandb_enabled or not is_writer():
            return opts, None
        return opts, _try_wandb()

    def metrics(self, data: Dict[str, Any]) -> None:
        opts, wandb = self._wandb()
        if wandb is None:
            printable = {k: (v if isinstance(v, (float, int, str))
                             else f"<{type(v).__name__}>")
                         for k, v in data.items()}
            self.log(f"METRICS: {printable}")
            return
        step = (opts.wandb_global_step or 0) + 1
        wandb.log(data, step=step)
        opts.wandb_global_step = step

    def _dump(self) -> Dict[str, Any]:
        """The config as the file holds it, the loggers' live state in."""
        raw = copy.deepcopy(self.config.raw)
        for name in LOGGERS:
            opts = getattr(self.config, name)
            if opts is not None:
                raw[name] = {k: v for k, v in dataclasses.asdict(opts).items()
                             if v is not None or k in raw[name]}
        return raw

    def flush_cfg(self) -> None:
        """Rewrite .hparams.json in place (indented); rank 0 only."""
        if not is_writer():
            return
        (self.model_path / ".hparams.json").write_text(
            json.dumps(self._dump(), indent=2) + "\n", "utf-8")
        self.log("[i] updated config file")

    def close(self) -> None:
        if self._owner and self._log_fd is not None:
            with self._log_lock:
                self._log_fd.close()

    def __enter__(self) -> "ExpEnv":
        flattened = flatten_dict({k: v for k, v in self._dump().items()
                                  if k not in LOGGERS})
        self.log("CONFIG: " + json.dumps(flattened, indent=2))
        opts, wandb = self._wandb()
        if wandb is None:
            return self
        wandb.init(id=opts.wandb_run_id, project=opts.wandb_project,
                   name=opts.wandb_name, config=flattened, resume="allow")
        if wandb.run is not None:
            opts.wandb_run_id = wandb.run.id
            self.flush_cfg()  # the run id, for resumption
        self.log(f"[[[ wandb enabled: {opts.wandb_project} / "
                 f"{opts.wandb_name} / {opts.wandb_run_id} ]]]")
        return self

    def __exit__(self, *exc) -> None:
        _, wandb = self._wandb()
        if wandb is not None and wandb.run is not None:
            wandb.run.finish()
            self.log("[[[ wandb finished ]]]")
        self.close()
