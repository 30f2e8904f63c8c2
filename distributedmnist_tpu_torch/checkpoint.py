"""Asynchronous checkpoint/restore in the port's own format — the port
of distributedmnist_tpu/checkpoint.py (which writes orbax trees; the
card's machine has neither jax nor orbax, and JAX weights come across
through interop.py instead).

A checkpoint of step N is the directory `<dir>/N/` holding two files
written with torch.save: `params.pt` (the model's state_dict) and
`train_state.pt` ({step, optimizer, scheduler} state_dicts). Params sit
in a file of their own so that a params-only restore (serving) never
reads the optimizer's moments.

The save is asynchronous: save() copies every tensor to the host on the
calling thread (so training may go on changing its own), and one worker
thread writes the files into `<dir>/N.tmp-<pid>/`, syncs them to disk
and renames the directory to `<dir>/N/`. Only all-digit directories are
committed checkpoints (`committed_steps`), so a save cut off halfway is
never restored. The newest `max_to_keep` committed steps are kept.

Under data parallelism every rank holds the same state, and the ranks
share the checkpoint directory (a filesystem they all see, as orbax
assumes), so only rank 0 writes: save() on any other rank does nothing,
which stands in for orbax's "every process calls save; process 0 owns
the commit". On restore rank 0 picks the newest committed step and
broadcasts it, and every rank loads that step.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import shutil
from typing import Any, Optional, Tuple

import torch

from distributedmnist_tpu_torch.parallel import distributed

log = logging.getLogger("distributedmnist_tpu_torch")

PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"


def committed_steps(directory: str) -> list[int]:
    """Step numbers of the checkpoints fully committed in `directory`: an
    in-progress save lives in a tmp-suffixed directory, never an
    all-digit one, so the digit-only listing is exactly the committed
    set."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_latest_params(directory: str, template: Optional[dict] = None,
                          step: Optional[int] = None
                          ) -> Tuple[Optional[dict], Optional[int]]:
    """Params-only restore for serving: read `params.pt` of the latest
    committed checkpoint (or of `step`), never the optimizer state.
    Returns (params as CPU tensors, step), or (None, None) when the
    directory holds no committed checkpoint. With a `template` (a
    state_dict of the model to serve), a checkpoint whose parameter
    names or shapes differ raises ValueError naming the directory."""
    if step is None:
        steps = committed_steps(directory)
        if not steps:
            return None, None
        step = steps[-1]
    params = _load(os.path.join(directory, str(step), PARAMS_FILE))
    if template is not None:
        want = {k: tuple(v.shape) for k, v in template.items()}
        got = {k: tuple(v.shape) for k, v in params.items()}
        if want != got:
            raise ValueError(
                f"checkpoint at step {step} in {directory!r} does not hold "
                f"params for this model: expected {want}, found {got}")
    return params, step


def _to_host(obj: Any) -> Any:
    """A copy of `obj` with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.writer = distributed.process_index() == 0
        if self.writer:
            os.makedirs(self.directory, exist_ok=True)
        # one directory scan a lifetime: save() skips a step saved before
        self._saved_steps = set(committed_steps(self.directory))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint-writer")
        self._pending: list[concurrent.futures.Future] = []

    def save(self, step: int, state: dict) -> bool:
        """Save `state` = {params, optimizer, scheduler} as step `step`.
        Returns once every tensor is on the host; the write goes on in
        the background. False when this step was saved already, and on
        every rank but rank 0."""
        if not self.writer or step in self._saved_steps:
            return False
        self._reap(block=False)
        params = _to_host(state["params"])
        rest = _to_host({"step": step, "optimizer": state["optimizer"],
                         "scheduler": state["scheduler"]})
        self._pending.append(
            self._pool.submit(self._commit, step, params, rest))
        self._saved_steps.add(step)
        return True

    def _commit(self, step: int, params: dict, rest: dict) -> None:
        tmp = os.path.join(self.directory, f"{step}.tmp-{os.getpid()}")
        final = os.path.join(self.directory, str(step))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _write(os.path.join(tmp, PARAMS_FILE), params)
        _write(os.path.join(tmp, STATE_FILE), rest)
        os.replace(tmp, final)
        fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(fd)      # the rename itself is durable
        finally:
            os.close(fd)
        for old in committed_steps(self.directory)[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def _reap(self, block: bool) -> None:
        """Collect finished writes (all of them with `block`), raising the
        first write's error."""
        keep = []
        for fut in self._pending:
            if block or fut.done():
                fut.result()
            else:
                keep.append(fut)
        self._pending = keep

    def maybe_restore(self, device="cpu") -> Optional[dict]:
        """{step, params, optimizer, scheduler} of the latest committed
        checkpoint as CPU tensors, or None when there is none. In a
        process group, the latest is rank 0's reading, broadcast on the
        rank's `device`."""
        steps = committed_steps(self.directory) if self.writer else []
        step = distributed.broadcast_int(steps[-1] if steps else -1, device)
        if step < 0:
            return None
        path = os.path.join(self.directory, str(step))
        state = _load(os.path.join(path, STATE_FILE))
        if state["step"] != step:
            raise ValueError(f"checkpoint directory {path!r} holds step "
                             f"{state['step']}")
        state["params"] = _load(os.path.join(path, PARAMS_FILE))
        return state

    def wait(self) -> None:
        """Block until every save so far is committed."""
        self._reap(block=True)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
