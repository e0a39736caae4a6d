"""Stage attribution of the VQ-VAE's training step (``tools/profile_train.py``).

On the marginal timer (:func:`pccf_torch.utils.timing.marginal_time`), at
``batch`` synthetic clouds of ``n`` points under ChamferEMD (the flagship
objective, random-free: the decoder's sampling and Gumbel noise drawn once
from seed 7): the trainer's whole step (forward, loss, backward, AdamW),
the loss's forward in eval and in training, the whole gradient, the
encoder's forward (training and eval) and forward + backward, the decoder's
forward + backward from the encoder's latent, the objective alone on a
fixed output, and the AdamW update on cached gradients.  The decoder and
loss's backward is also derived as the whole gradient less the encoder's.
Prints one JSON object of milliseconds; on the card unless ``--cpu``.

    python -m pccf_torch.tools.profile_train [--batch 8] [--n 2048] [--cpu]
"""

from __future__ import annotations

import json

import torch

from pccf_torch import cli
from pccf_torch.data.dataset import get_datasets
from pccf_torch.data.protocols import Singleton
from pccf_torch.data.structures import Inputs, Outputs
from pccf_torch.nn.layers import gumbel_uniform
from pccf_torch.profile_cf import parse_sizes
from pccf_torch.train.autoencoder import build
from pccf_torch.train.losses import get_autoencoder_loss
from pccf_torch.train.runners import Loader, Trainer, with_epoch
from pccf_torch.utils.timing import marginal_time


def main(batch: int = 8, n: int = 2048, k_short: int = 2, k_long: int = 6, repeats: int = 2,
         device: torch.device | str = 'cuda', overrides: tuple[str, ...] = ()) -> dict[str, float]:
    """Print and return each piece's milliseconds."""
    device = torch.device(device)
    Singleton.reset_all()
    cfg, _ = cli.get_config(['data/dataset=synthetic', 'data.dataset.n_classes=2', f'data.n_input_points={n}',
                             f'data.n_target_points={n}', f'autoencoder.train.batch_size={batch}',
                             'autoencoder.objective.recon_loss=ChamferEMD', *overrides])
    model = build(cfg, 0).to(device)
    train_set, _ = get_datasets(cfg, device)
    inputs, targets = next(iter(Loader(train_set, batch).epoch_iterator(1)))
    cloud = inputs.cloud
    objective = get_autoencoder_loss(cfg)
    trainer = Trainer(model, objective, cfg.autoencoder.train, 1, seed=0, name='prof')
    gen = torch.Generator(device=device).manual_seed(7)
    sampling = torch.randn((batch, model.n_training_output_points, model.decoder.sample_dim), generator=gen,
                           device=device)
    noise = gumbel_uniform((batch, model.n_training_output_points, model.decoder.n_components), gen, device)
    fixed = Inputs(cloud, inputs.indices, sampling)
    params = [p for p in model.parameters() if p.requires_grad]
    report: dict[str, float] = {}

    def timed(name: str, step, carry=None) -> None:
        report[name] = 1e3 * marginal_time(step, cloud if carry is None else carry, k_short, k_long, repeats)

    def loss_of(train: bool) -> torch.Tensor:
        model.train(train)
        out = with_epoch(model(fixed, noise if train else None), 1.0)
        return objective.loss_and_metrics(out, targets)[0]

    # the trainer's whole step: forward, loss, backward, AdamW
    timed('full_step_ms', lambda c: c + 0 * trainer.run_step(fixed, targets, noise, epoch=1.0)[objective.name])

    def no_grad(fn):
        def step(c):
            with torch.no_grad():
                return fn(c)
        return step

    timed('fwd_eval_ms', no_grad(lambda c: c + 0 * loss_of(False)))
    timed('fwd_train_ms', no_grad(lambda c: c + 0 * loss_of(True)))

    def whole_gradient(c):
        grads = torch.autograd.grad(loss_of(True), params, allow_unused=True)
        return c + 0 * next(g for g in grads if g is not None).flatten()[0]

    timed('fwd_bwd_ms', whole_gradient)

    def encoder(c, train: bool) -> torch.Tensor:
        model.encoder.train(train)
        w = model.encoder(c, inputs.indices)
        return torch.sum(w * w)

    enc_params = [p for p in model.encoder.parameters() if p.requires_grad]
    timed('encoder_fwd_ms', no_grad(lambda c: c + 1e-12 * encoder(c, True)))
    timed('encoder_fwd_bwd_ms', lambda c: c + 0 * torch.autograd.grad(encoder(c, True), enc_params)[0].flatten()[0])
    timed('encoder_eval_ms', no_grad(lambda c: c + 1e-12 * encoder(c, False)))

    # the decoder's forward + backward from the encoder's latent (quantised, straight through)
    model.train()
    with torch.no_grad():
        w_q = model.encode(fixed).w_q
    dec_params = [p for p in model.decoder.parameters() if p.requires_grad]

    def decoder(wq):
        recon = model.decode(Outputs(w_q=wq.requires_grad_(True)), fixed, noise).recon
        grads = torch.autograd.grad(torch.sum(recon * recon), [wq, *dec_params])
        return wq.detach() + 1e-12 * grads[0]

    timed('decoder_fwd_bwd_ms', decoder, w_q.clone())
    with torch.no_grad():
        out = with_epoch(model(fixed, noise), 1.0)
    # the objective on a fixed output, its cloud the carry: a new tensor each
    # step, so that the paired terms' one-launch cache misses as in training
    timed('loss_ms', no_grad(lambda r: r + 0 * objective.loss_and_metrics(out.replace(recon=r), targets)[0]),
          out.recon)

    # the AdamW update on cached gradients
    grads = torch.autograd.grad(loss_of(True), params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g

    def update(c):
        trainer.optimizer.step()
        return c

    timed('optimizer_ms', update)

    report = {k: round(v, 4) for k, v in report.items()}
    report['derived_decoder_loss_bwd_ms'] = round(report['fwd_bwd_ms'] - report['encoder_fwd_bwd_ms'], 4)
    print(json.dumps(report), flush=True)
    return report


if __name__ == '__main__':
    sizes, dev = parse_sizes(__doc__.split('\n\n')[0], batch=8, n=2048)
    main(**sizes, device=dev)
