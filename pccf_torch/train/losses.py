"""Stage-1, stage-2 and classification losses (``pccf/train/losses.py:27-137,
148-300, 302-312``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pccf_torch.config import SliceConfig, WAutoEncoderTrainConfig
from pccf_torch.data.structures import Outputs, Targets, WTargets
from pccf_torch.kernels import api
from pccf_torch.train.objectives import Loss, Metric, Objective

RECON_LOSSES = ('Chamfer', 'ChamferEMD', 'ChamferSinkhorn')  # pccf/config/options.py:72-77


def get_chamfer_loss() -> Objective:
    """Chamfer, the mean over the points of each direction."""

    def _chamfer(data: Outputs, targets: Targets) -> torch.Tensor:
        return api.chamfer(data.recon, targets.ref_cloud)

    return Loss(_chamfer, 'Chamfer')


def get_emd_loss() -> Objective:
    """ApproxMatch EMD."""

    def _emd(data: Outputs, targets: Targets) -> torch.Tensor:
        return api.match_cost(data.recon, targets.ref_cloud)

    return Loss(_emd, 'EMD')


def _paired_losses(pair_fn) -> tuple[Objective, Objective]:
    """Chamfer and a transport cost sharing one kernel launch: the second
    term finds the pair the first computed for the same ``(recon,
    ref_cloud)`` tensors."""
    cache: list = []

    def _pair(data: Outputs, targets: Targets) -> tuple[torch.Tensor, torch.Tensor]:
        a, b = data.recon, targets.ref_cloud
        if len(cache) == 3 and cache[0] is a and cache[1] is b:
            return cache[2]
        out = pair_fn(a, b)
        cache[:] = [a, b, out]
        return out

    def _chamfer(data: Outputs, targets: Targets) -> torch.Tensor:
        return _pair(data, targets)[0]

    def _cost(data: Outputs, targets: Targets) -> torch.Tensor:
        return _pair(data, targets)[1]

    return Loss(_chamfer, 'Chamfer'), Loss(_cost, 'EMD')


def get_chamfer_emd_losses() -> tuple[Objective, Objective]:
    """Chamfer and ApproxMatch EMD from one launch."""
    return _paired_losses(api.chamfer_match_cost)


def get_chamfer_sinkhorn_losses() -> tuple[Objective, Objective]:
    """Chamfer and the Sinkhorn surrogate from one launch, the surrogate
    under the monitor name ``'EMD'``."""
    return _paired_losses(api.chamfer_sinkhorn_cost)


def get_recon_loss(cfg: SliceConfig) -> Objective:
    """The reconstruction objective ``autoencoder.train.recon_loss`` names
    (``pccf/train/losses.py:111-128``).  JAX drops the EMD term of ChamferEMD
    under ``user.cpu``, where its Pallas kernel does not run; the port keeps
    it, as a CPU tensor runs the kernel's plain version."""
    recon = cfg.autoencoder.train.recon_loss
    if recon not in RECON_LOSSES:
        raise ValueError(f'recon_loss must be one of {RECON_LOSSES}, got {recon!r}')
    if recon == 'ChamferEMD':
        chamfer_term, cost_term = get_chamfer_emd_losses()
        return chamfer_term + cost_term
    if recon == 'ChamferSinkhorn':
        chamfer_term, cost_term = get_chamfer_sinkhorn_losses()
        return chamfer_term + cost_term
    return get_chamfer_loss()


def get_embed_loss() -> Objective:
    """MSE between the encoding and its quantisation, per sample."""

    def _embed(data: Outputs, _t: Targets) -> torch.Tensor:
        return torch.mean((data.w_q - data.w_e) ** 2, dim=1)

    return Loss(_embed, 'Embed. Loss')


def get_autoencoder_loss(cfg: SliceConfig) -> Objective:
    """The reconstruction objective + ``c_embedding`` · embedding loss
    (``pccf/train/losses.py:307-312``; the port's VQ-VAE is always the
    counterfactual one, which has the embedding term)."""
    return get_recon_loss(cfg) + cfg.autoencoder.train.c_embedding * get_embed_loss()


# ----------------------------------------------------------------- stage 2


def gaussian_kld(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, σ²) ‖ N(0, 1)) per element."""
    return 0.5 * (-1.0 - log_var + torch.exp(log_var) + mu**2)


def diff_gaussian_kld(d_mu: torch.Tensor, d_log_var: torch.Tensor, p_log_var: torch.Tensor) -> torch.Tensor:
    """KL of the posterior (the prior shifted by ``d_mu``, scaled by
    ``exp(d_log_var)``) from the prior, per element."""
    return 0.5 * (-1.0 - d_log_var + torch.exp(d_log_var) + d_mu**2 / torch.exp(p_log_var))


def get_kld1_loss() -> Objective:
    def _kld1(data: Outputs, _t: WTargets) -> torch.Tensor:
        return torch.sum(gaussian_kld(data.mu1, data.log_var1), dim=(1, 2))

    return Loss(_kld1, 'KLD1')


def get_kld2_loss() -> Objective:
    def _kld2(data: Outputs, _t: WTargets) -> torch.Tensor:
        return torch.sum(diff_gaussian_kld(data.d_mu2, data.d_log_var2, data.p_log_var2), dim=(1, 2))

    return Loss(_kld2, 'KLD2')


def get_annealing(n_epochs: int) -> Objective:
    """Cosine ramp of the KLD weight from 0 to 1 over ``n_epochs``, read from
    ``Outputs.model_epoch``."""

    def _anneal(data: Outputs, _t: WTargets) -> torch.Tensor:
        frac = torch.clamp(torch.as_tensor(data.model_epoch, dtype=torch.float32, device=data.mu1.device)
                           / n_epochs, 0.0, 1.0)
        return 0.5 * (1.0 - torch.cos(frac * math.pi))

    return Loss(_anneal, 'Annealing')


def gaussian_ll(x: torch.Tensor, mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """The Gaussian log-likelihood of ``pccf/train/losses.py:145-147``, with
    its ``+ log(2π)`` sign kept as the reference has it."""
    return -0.5 * (log_var + (x - mu) ** 2 / torch.exp(log_var)) + math.log(2 * math.pi)


def get_kld_vamp_loss(n_pseudo_inputs: int) -> Objective:
    """The VampPrior's KLD (``losses.py:172-186``): z1's posterior
    log-likelihood less the log of the mean over the pseudo-inputs of its
    likelihood under their z1 posteriors."""

    def _vamp(data: Outputs, _t: WTargets) -> torch.Tensor:
        posterior_ll = torch.sum(gaussian_ll(data.z1, data.mu1, data.log_var1), dim=(1, 2))
        prior_ll = torch.logsumexp(torch.sum(gaussian_ll(data.z1[:, None], data.pseudo_mu1[None],
                                                         data.pseudo_log_var1[None]), dim=(2, 3)), dim=1)
        return posterior_ll - prior_ll + math.log(n_pseudo_inputs)

    return Loss(_vamp, 'KLD2_VAMP')


def get_kld_loss(cfg: WAutoEncoderTrainConfig, n_pseudo_inputs: int = 0) -> Objective:
    """``annealing · (c_kld1 · KLD1 + c_kld2 · KLD2)``, the VampPrior's KLD in
    place of KLD1 with pseudo-inputs (``losses.py:200-206``)."""
    kld1 = get_kld_vamp_loss(n_pseudo_inputs) if n_pseudo_inputs > 0 else get_kld1_loss()
    return get_annealing(cfg.n_epochs) * (cfg.c_kld1 * kld1 + cfg.c_kld2 * get_kld2_loss())


def get_nll_loss() -> Objective:
    """The codebook-distance NLL (``losses.py:212-228``), with the reference's
    normaliser kept: the sum of the squared distances themselves, so the term
    is ``log(Σ d²) + log(d²)`` of the selected entry."""

    def _nll(data: Outputs, targets: WTargets) -> torch.Tensor:
        w_weights = 1.0 / torch.clamp_min(data.w_dist_2, 1e-6)
        sum_weights = torch.sum(data.w_dist_2, dim=2, keepdim=True)
        return torch.sum((torch.log(sum_weights) - torch.log(w_weights)) * targets.one_hot_idx, dim=(1, 2))

    return Loss(_nll, 'NLL')


def get_mse_loss() -> Objective:
    """Squared error of the reconstructed code embeddings, summed over w_dim."""

    def _mse(data: Outputs, targets: WTargets) -> torch.Tensor:
        return torch.sum((data.w_recon - targets.w_e) ** 2, dim=1)

    return Loss(_mse, 'MSE')


def get_w_accuracy() -> Objective:
    """Share of code slots whose nearest codebook entry is the target's."""

    def _acc(data: Outputs, targets: WTargets) -> torch.Tensor:
        pred = F.one_hot(torch.argmin(data.w_dist_2, dim=2), targets.one_hot_idx.shape[2]).to(torch.float32)
        return torch.mean(torch.sum(targets.one_hot_idx * pred, dim=2), dim=1)

    return Metric(_acc, 'Quantisation Accuracy', higher_is_better=True)


def get_w_autoencoder_loss(cfg: WAutoEncoderTrainConfig, n_pseudo_inputs: int = 0) -> Objective:
    """MSE + annealed KLD, with the quantisation accuracy reported."""
    return (get_mse_loss() + get_kld_loss(cfg, n_pseudo_inputs)) | get_w_accuracy()


# ------------------------------------------------------------ classification


def get_cross_entropy_loss() -> Objective:
    """Cross entropy of the logits ``(B, C)`` against ``targets.label``."""

    def _ce(logits: torch.Tensor, targets: Targets) -> torch.Tensor:
        return -torch.gather(F.log_softmax(logits, dim=-1), 1, targets.label[:, None].long())[:, 0]

    return Loss(_ce, 'CrossEntropy')


def _correct(logits: torch.Tensor, targets: Targets) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == targets.label).to(torch.float32)


def get_accuracy() -> Objective:
    return Metric(_correct, 'Accuracy', higher_is_better=True)


def _macro_sums(logits: torch.Tensor, targets: Targets) -> torch.Tensor:
    """Each class's correct predictions and samples in the batch, ``(2, C)``."""
    onehot = F.one_hot(targets.label.long(), logits.shape[1]).to(torch.float32)
    return torch.stack([torch.sum(onehot * _correct(logits, targets)[:, None], dim=0), torch.sum(onehot, dim=0)])


def _macro_from_sums(sums: torch.Tensor) -> torch.Tensor:
    per_class_correct, per_class_count = sums[0], sums[1]
    present = per_class_count > 0
    recalls = torch.where(present, per_class_correct / torch.clamp_min(per_class_count, 1.0), 0.0)
    return torch.sum(recalls) / torch.clamp_min(torch.sum(present), 1)


def get_macro_accuracy() -> Objective:
    """The recall of each class present in the batch, averaged over those
    classes: one value per batch (``losses.py:267-281``), which the running
    state weighs by the batch size, so a pass's macro accuracy is a mean of
    per-batch values, not the dataset's macro recall.  A data-parallel step
    pools the per-class counts over the global batch."""

    def _macro(logits: torch.Tensor, targets: Targets) -> torch.Tensor:
        return _macro_from_sums(_macro_sums(logits, targets))

    return Metric(_macro, 'Macro Accuracy', higher_is_better=True, pooled=(_macro_sums, _macro_from_sums))


def get_f1() -> Objective:
    """Micro F1, which equals the accuracy for single-label classes."""
    return Metric(_correct, 'F1_Score', higher_is_better=True)


def get_classification_loss() -> Objective:
    """Cross entropy, with the accuracy and the macro accuracy reported."""
    return get_cross_entropy_loss() | get_accuracy() | get_macro_accuracy()
