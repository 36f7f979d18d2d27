"""Monitoring fan-out — analog of ``deepspeed/monitor/monitor.py:24``
(MonitorMaster → TensorBoard/WandB/CSV writers). Events are
``(name, value, global_sample_count)`` triples exactly as the engine emits
them (runtime/engine.py:1946). The engine routes the same events through
the telemetry registry (``RegistryMonitor``) so they are scrapeable even
with every backend here disabled — MonitorMaster is one sink of several
(docs/observability.md).

Copy of ``deepspeed_tpu/monitor/monitor.py``; a backend writes on
process 0 only (``comm.get_rank()``, 0 without a process group), where
JAX asks ``jax.process_index()``."""
from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.telemetry.registry import (MetricRegistry,
                                                    get_registry,
                                                    sanitize_metric_name)
from deepspeed_tpu_torch.utils.logging import logger

Event = Tuple[str, float, int]


class Monitor:
    def __init__(self, config):
        self.enabled = False

    def write_events(self, event_list: List[Event]):
        raise NotImplementedError

    def close(self):
        """Release file handles / writers; safe to call twice. Backends
        that hold nothing inherit the no-op."""


class CsvMonitor(Monitor):
    def __init__(self, csv_config):
        self.enabled = csv_config.enabled and comm.get_rank() == 0
        self.output_path = csv_config.output_path or "./csv_monitor"
        self.job_name = csv_config.job_name
        self._files = {}
        if self.enabled:
            os.makedirs(os.path.join(self.output_path, self.job_name),
                        exist_ok=True)

    def _file(self, name):
        if name not in self._files:
            safe = name.replace("/", "_")
            path = os.path.join(self.output_path, self.job_name, f"{safe}.csv")
            f = open(path, "a", newline="")
            self._files[name] = (f, csv.writer(f))
        return self._files[name]

    def write_events(self, event_list: List[Event]):
        if not self.enabled:
            return
        for name, value, step in event_list:
            f, writer = self._file(name)
            writer.writerow([step, value])
            f.flush()

    def close(self):
        # handles reopen on the next write (append mode), so close() at
        # engine teardown cannot strand a later flush
        for f, _ in self._files.values():
            f.close()
        self._files = {}


class TensorBoardMonitor(Monitor):
    def __init__(self, tb_config):
        self.enabled = tb_config.enabled and comm.get_rank() == 0
        self.summary_writer = None
        if self.enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
                path = os.path.join(tb_config.output_path or "./runs",
                                    tb_config.job_name)
                self.summary_writer = SummaryWriter(log_dir=path)
            except Exception as e:
                logger.warning(f"tensorboard unavailable: {e}")
                self.enabled = False

    def write_events(self, event_list: List[Event]):
        if not self.enabled:
            return
        for name, value, step in event_list:
            self.summary_writer.add_scalar(name, value, step)
        self.summary_writer.flush()

    def close(self):
        if self.summary_writer is not None:
            try:
                self.summary_writer.close()
            except Exception as e:  # noqa: BLE001 — teardown must not raise
                logger.warning(f"tensorboard close failed: {e}")
            self.summary_writer = None
            self.enabled = False


class WandbMonitor(Monitor):
    def __init__(self, wandb_config):
        self.enabled = wandb_config.enabled and comm.get_rank() == 0
        self._wandb = None
        if self.enabled:
            try:
                import wandb
                wandb.init(project=wandb_config.project,
                           group=wandb_config.group, entity=wandb_config.team)
                self._wandb = wandb
            except Exception as e:
                logger.warning(f"wandb unavailable: {e}")
                self.enabled = False

    def write_events(self, event_list: List[Event]):
        if not self.enabled:
            return
        for name, value, step in event_list:
            self._wandb.log({name: value}, step=step)

    def close(self):
        if self._wandb is not None:
            try:
                self._wandb.finish()
            except Exception as e:  # noqa: BLE001
                logger.warning(f"wandb finish failed: {e}")
            self._wandb = None
            self.enabled = False


class RegistryMonitor(Monitor):
    """Sink that lands monitor events in the telemetry registry: each
    event name becomes a gauge (``Train/Samples/train_loss`` →
    ``train_samples_train_loss``), the sample clock lands in
    ``train_samples`` — so a scraper sees training step metrics with
    zero backend configuration. The four core train-step scalars are
    ALSO published under canonical short names (``train_loss``,
    ``train_grad_norm``, ``train_lr``, ``train_loss_scale``) so
    dashboards don't have to know the reference's ``Train/Samples/...``
    event spelling."""

    def __init__(self, registry: Optional[MetricRegistry] = None):
        self.registry = registry or get_registry()
        self.enabled = True

    def _canonical(self, name: str, value: float) -> None:
        # spelled out per name (not a loop over a mapping) so the
        # metric-catalog gate (scripts/check_metric_docs.py) can
        # resolve every registration statically
        if name == "Train/Samples/train_loss":
            self.registry.gauge(
                "train_loss",
                help="mean loss of the last reported train step").set(value)
        elif name == "Train/Samples/lr":
            self.registry.gauge(
                "train_lr",
                help="learning rate at the last reported train step"
            ).set(value)
        elif name == "Train/Samples/loss_scale":
            self.registry.gauge(
                "train_loss_scale",
                help="fp16 dynamic loss scale at the last reported "
                     "train step").set(value)
        elif name == "Train/Samples/grad_norm":
            self.registry.gauge(
                "train_grad_norm",
                help="global (pre-clip) gradient norm of the last "
                     "reported train step").set(value)

    def write_events(self, event_list: List[Event]):
        for name, value, step in event_list:
            self.registry.gauge(
                sanitize_metric_name(name),
                help=f"monitor event {name!r} (runtime/engine.py)"
            ).set(float(value))
            self._canonical(name, float(value))
            self.registry.gauge(
                "train_samples",
                help="global sample count at the last monitor event"
            ).set(float(step))


class MonitorMaster(Monitor):
    def __init__(self, ds_config):
        self.tb_monitor = TensorBoardMonitor(ds_config.tensorboard)
        self.wandb_monitor = WandbMonitor(ds_config.wandb)
        self.csv_monitor = CsvMonitor(ds_config.csv_monitor)
        self.monitors = [self.tb_monitor, self.wandb_monitor,
                         self.csv_monitor]
        self.enabled = any(m.enabled for m in self.monitors)

    def write_events(self, event_list: List[Event]):
        for m in self.monitors:
            if m.enabled:
                m.write_events(event_list)

    def close(self):
        for m in self.monitors:
            m.close()

    def __enter__(self) -> "MonitorMaster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
