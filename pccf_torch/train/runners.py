"""The stage-1 training step (``pccf/train/runners.py:222-324``).

:class:`Trainer` holds a VQ-VAE, its objective and an AdamW optimiser set as
``optax.adamw(lr, weight_decay)`` is (betas 0.9 / 0.999, eps 1e-8, decoupled
decay on every trained parameter, BatchNorm and the codebook included).  The
embedded inner CVAE is frozen: it is left out of the optimiser, so neither
updates nor weight decay touch it (``runners.py:245-256``,
``train_autoencoder.py:68``).  The learning rate has epoch resolution,
``base_lr · schedule(step // steps_per_epoch)`` (``runners.py:226-229``).
A step draws the decoder's ``initial_sampling`` and the attention's Gumbel
noise from the trainer's ``torch.Generator`` on the model's device unless the
caller passes them.
"""

from __future__ import annotations

import torch

from pccf_torch.config import AutoEncoderTrainConfig
from pccf_torch.data.structures import Inputs, Targets
from pccf_torch.models.autoencoders import VQVAE
from pccf_torch.nn.layers import gumbel_uniform
from pccf_torch.train.objectives import Objective
from pccf_torch.train.schedulers import get_scheduler

FROZEN = 'w_autoencoder'  # the submodule stage 1 does not train


class Trainer:
    """One optimisation step at a time of a :class:`VQVAE`."""

    def __init__(
        self, model: VQVAE, objective: Objective, cfg: AutoEncoderTrainConfig, steps_per_epoch: int, seed: int = 0
    ) -> None:
        self.model = model
        self.objective = objective
        self.base_lr = cfg.learning_rate
        self.schedule = get_scheduler(cfg.scheduler)
        self.steps_per_epoch = steps_per_epoch
        trained = []
        for name, p in model.named_parameters():
            if name.split('.')[0] == FROZEN:
                p.requires_grad_(False)
            else:
                trained.append(p)
        self.optimizer = torch.optim.AdamW(
            trained, lr=self.lr_at(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay
        )
        self.step = 0
        self.generator = torch.Generator(device=model.codebook.device).manual_seed(seed)

    def lr_at(self, step: int) -> float:
        return self.base_lr * self.schedule(step // self.steps_per_epoch)

    def draw(self, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``initial_sampling (B, n_train, sample_dim)`` and the Gumbel noise
        ``(B, n_train, n_components)`` of one step."""
        dec, n = self.model.decoder, self.model.n_training_output_points
        dev = self.model.codebook.device
        sampling = torch.randn((batch, n, dec.sample_dim), generator=self.generator, device=dev)
        return sampling, gumbel_uniform((batch, n, dec.n_components), self.generator, dev)

    def run_step(
        self, inputs: Inputs, targets: Targets, gumbel: torch.Tensor | None = None
    ) -> dict[str, torch.Tensor]:
        """One step: forward in train mode, loss, backward, AdamW.  Returns the
        batch-mean metrics (device tensors: reading them waits for the step)."""
        if inputs.initial_sampling is None or gumbel is None:
            sampling, noise = self.draw(inputs.cloud.shape[0])
            if inputs.initial_sampling is None:
                inputs = Inputs(inputs.cloud, inputs.indices, sampling)
            gumbel = noise if gumbel is None else gumbel
        self.model.train()
        for group in self.optimizer.param_groups:
            group['lr'] = self.lr_at(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        outputs = self.model(inputs, gumbel)
        loss, metrics = self.objective.loss_and_metrics(outputs, targets)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {name: v.detach() for name, v in metrics.items()}
