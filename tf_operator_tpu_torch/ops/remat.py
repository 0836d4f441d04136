"""Outputs that a remat policy saves, served to the checkpoint's replay.

A block under ``torch.utils.checkpoint`` runs twice: in the forward, and
again in the backward (the replay), to rebuild what its backward needs. A
:class:`Tape` keeps, in the forward, the outputs of the ops that its policy
saves, and hands them back in the same order in the replay in place of
running those ops again. The ops ask for it through :func:`saved` inside
their autograd Function's forward: the replay still builds the nodes whose
backward the block needs, and only the computation is skipped.

This is the counterpart of the JAX package's ``jax.checkpoint`` policies.
PyTorch's own selective checkpoint serves the same from a dispatch mode
that runs Python on every op of the block, forward and replay; the tape
costs Python only at the few ops it names.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, FrozenSet

# The tape of the block whose forward or replay this thread is running. The
# replay runs on the autograd engine's thread for the device.
_ACTIVE = threading.local()


class Tape:
    """The saved outputs of one checkpointed call, named by ``tags``."""

    def __init__(self, tags: FrozenSet[str]):
        self.tags = tags
        self._outputs: deque = deque()
        self._recorded = False

    def run(self, fn: Callable, *args):
        """``fn(*args)`` with this tape active: the first call records the
        outputs, the next one (the replay) takes them back and frees them."""
        replay, self._recorded = self._recorded, True
        prev = getattr(_ACTIVE, "state", None)
        _ACTIVE.state = (self, replay)
        try:
            return fn(*args)
        finally:
            _ACTIVE.state = prev
            if replay:  # a replay cut short by an error leaves outputs untaken
                self._outputs.clear()


def saving(tag: str) -> bool:
    """Whether the running block's policy saves the outputs tagged ``tag``."""
    state = getattr(_ACTIVE, "state", None)
    return state is not None and tag in state[0].tags


def saved(tag: str, compute: Callable):
    """``compute()``, a tensor or a tuple of tensors; under a tape that
    saves ``tag``, kept in the forward and taken from the tape, not
    computed, in the replay."""
    state = getattr(_ACTIVE, "state", None)
    if state is None or tag not in state[0].tags:
        return compute()
    tape, replay = state
    if replay:
        if not tape._outputs:
            raise RuntimeError(f"remat replay asked for a saved {tag!r} output the "
                               "forward did not keep (a second backward?)")
        return tape._outputs.popleft()
    out = compute()
    tape._outputs.append(tuple(t.detach() for t in out) if isinstance(out, tuple)
                         else out.detach())
    return out
