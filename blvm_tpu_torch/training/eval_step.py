"""The evaluation step (port of ``blvm_tpu/parallel/train_step.py:make_eval_step``).

One device, no sharding: the step runs the loss function under
``torch.inference_mode()`` and returns its metrics (and outputs).
"""

from typing import Callable

import torch


def make_eval_step(loss_fn: Callable, return_outputs: bool = True):
    """Build ``step(model, generator, batch, scalars)``.

    ``loss_fn(model, generator, batch, scalars)`` returns ``(loss, (mets, outputs))``
    as the JAX package's loss functions do.
    """
    def step(model, generator, batch, scalars):
        with torch.inference_mode():
            _, (mets, outputs) = loss_fn(model, generator, batch, scalars)
        if return_outputs:
            return mets, outputs
        return mets

    return step
