"""What each rank of the distributed CPU tests runs (tests/test_torch_port_dist.py,
tests/test_torch_port_sp.py).

A plain module, free of JAX, so that the spawned gloo ranks import only
torch and pccf_torch: :func:`train_cases` takes training steps from a
payload the test wrote and saves each rank's results; :func:`hook_cases`
runs the codebook hook and a stage-1 ``fit`` with early stopping and
checkpoints under two ranks; :func:`sp_cases` runs the sharded-point-axis
losses on four.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from pccf_torch.dist import mesh

torch.set_num_threads(1)


def build_trainer(kind: str, cfg, state: dict, steps_per_epoch: int, seed: int):
    """The model of ``kind`` with ``state`` and its stage's trainer."""
    from pccf_torch.models import WAETrainModule, build_vqvae, build_w_autoencoder
    from pccf_torch.nn import ClassifierTrainModule, build_classifier
    from pccf_torch.train import Trainer, get_autoencoder_loss, get_classification_loss, get_w_autoencoder_loss

    if kind == 'vqvae':
        model, loss, tcfg = build_vqvae(cfg), get_autoencoder_loss(cfg), cfg.autoencoder.train
    elif kind == 'wae':
        model = WAETrainModule(build_w_autoencoder(cfg), cfg.autoencoder.book_size)
        tcfg = cfg.w_autoencoder.train
        loss = get_w_autoencoder_loss(tcfg, cfg.w_autoencoder.n_pseudo_inputs)
    else:
        model = ClassifierTrainModule(build_classifier(cfg))
        loss, tcfg = get_classification_loss(), cfg.classifier.train
    (model.classifier if kind == 'classifier' else model).load_state_dict(state, strict=True)
    return Trainer(model, loss, tcfg, steps_per_epoch, seed=seed)


def take_steps(case: dict) -> dict:
    """A step on each of the case's global batches at its
    statistic groups: the metrics of each step, the gradients and the state
    after the last, the bytes all-reduced."""
    os.environ['PCCF_BN_GROUPS'] = str(case['groups'])
    try:
        trainer = build_trainer(case['kind'], case['config'], case['state'], case['steps_per_epoch'], case['seed'])
        metrics = []
        for inputs, targets, noise in case['batches']:
            metrics.append({k: float(v) for k, v in trainer.run_step(inputs, targets, noise).items()})
    finally:
        del os.environ['PCCF_BN_GROUPS']
    model = trainer.model.classifier if case['kind'] == 'classifier' else trainer.model  # the names of its state
    return {'metrics': metrics, 'state': {k: v.clone() for k, v in model.state_dict().items()},
            'grads': {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None},
            'allreduce_bytes': trainer.allreduce_bytes}


def train_cases(payload: str, out_dir: str) -> None:
    """Every case of the payload, each ``case['repeat']`` times from the
    same start; this rank's results to ``out_dir/rank<r>.pt``."""
    cases = torch.load(payload, weights_only=False)
    results = [[take_steps(case) for _ in range(case.get('repeat', 1))] for case in cases]
    torch.save(results, pathlib.Path(out_dir) / f'rank{mesh.rank()}.pt')


class _Usage:
    """A diagnostic pass that found the given code usage counts."""

    def __init__(self, usage: np.ndarray) -> None:
        self.code_usage = torch.from_numpy(usage.astype(np.float32))

    def __call__(self, epoch: int) -> None:
        pass


def hook_cases(payload: str, out_dir: str) -> None:
    """The codebook hook twice (an epoch, then the final one) on the
    payload's codebook and usage, each rank's generator seeded apart; then a
    stage-1 ``fit`` with early stopping and a checkpoint every epoch,
    recording each checkpoint write with its rank."""
    import types

    from pccf_torch.experiment import Experiment
    from pccf_torch.train import autoencoder
    from pccf_torch.train.checkpoint import Checkpoint
    from pccf_torch.train.hooks import DiscreteSpaceOptimizer

    case = torch.load(payload, weights_only=False)
    r = mesh.rank()
    model = types.SimpleNamespace(codebook=torch.nn.Parameter(torch.from_numpy(case['codebook'].copy())))
    hook = DiscreteSpaceOptimizer(_Usage(case['usage']), case['vq_noise'], case['final'], seed=r)
    books = []
    for epoch in (1, case['final']):
        hook(types.SimpleNamespace(model=model, epoch=epoch))
        books.append(model.codebook.detach().clone())

    writes = pathlib.Path(out_dir) / f'writes{r}.txt'
    save = Checkpoint.save

    def recording_save(self, module, epoch):
        with open(writes, 'a') as f:
            f.write(f'{r} {self.name} {epoch}\n')
        return save(self, module, epoch)

    Checkpoint.save = recording_save
    cfg = case['config']
    train, test = autoencoder._Clouds(case['train']), autoencoder._Clouds(case['test'])
    with Experiment(cfg, par_dir=case['exp_dir']).create_run(record=mesh.is_main_process()):
        out = autoencoder.fit(cfg, autoencoder.build(cfg, 0), train, test, n_epochs=case['n_epochs'], seed=0,
                              device=torch.device('cpu'), early_stopping=True, checkpoint_every=1, save=True)
    trainer = out['trainer']
    torch.save({'books': books, 'epoch': trainer.epoch, 'validation': trainer.validation_log,
                'state': trainer.model.state_dict()}, pathlib.Path(out_dir) / f'hook{r}.pt')


def run_all(steps: str, hooks: str, out_dir: str) -> None:
    """:func:`train_cases`, then :func:`hook_cases`."""
    train_cases(steps, out_dir)
    hook_cases(hooks, out_dir)


def fail_on_rank_one(cfg) -> None:
    if mesh.rank() == 1:
        raise RuntimeError('rank 1 fails')


def sp_cases(payload: str, out_dir: str) -> None:
    """The sharded-point-axis losses on this rank (tests/test_torch_port_sp.py):
    the grid errors, a 1-D grid of every rank and a 2 x 2 grid (rows first),
    then each case of the payload on its grid, this rank's slab of the
    global clouds in, its value, index and slab gradients out, saved to
    ``out_dir/sp<r>.pt``."""
    from pccf_torch.dist import make_2d_grid, slab, sp_chamfer, sp_knn, sp_match_cost

    cases = torch.load(payload, weights_only=False)
    errors = {}
    for name, call in (('indivisible', lambda: make_2d_grid(4, mp=3)), ('too_few', lambda: make_2d_grid(8, mp=2))):
        try:
            call()
        except (RuntimeError, ValueError) as e:
            errors[name] = (type(e).__name__, str(e))
    grids = {'1d': make_2d_grid(mesh.world_size(), mp=mesh.world_size()), '2x2': make_2d_grid(4, mp=2)}
    try:
        slab(torch.zeros(1, 30, 3), grids['1d'])
    except ValueError as e:
        errors['points'] = (type(e).__name__, str(e))
    layout = {name: {'dp': (g.index('dp'), g.dp), 'mp': (g.index('mp'), g.mp),
                     'groups': {a: None if g.group(a) is None else torch.distributed.get_process_group_ranks(g.group(a))
                                for a in ('dp', 'mp')}}
              for name, g in grids.items()}
    results = []
    for case in cases:
        grid, batch_axis = grids[case['grid']], case['batch_axis']
        x = slab(torch.from_numpy(case['x']), grid, batch_axis=batch_axis).clone().requires_grad_(True)
        if case['kind'] == 'knn':
            results.append({'idx': sp_knn(x, case['k'], grid, batch_axis=batch_axis)})
            continue
        y = slab(torch.from_numpy(case['y']), grid, batch_axis=batch_axis).clone().requires_grad_(True)
        if case['kind'] == 'chamfer':
            value = sp_chamfer(x, y, grid, batch_axis=batch_axis, reduction=case['reduction'])
        else:
            value = sp_match_cost(x, y, grid, batch_axis=batch_axis)
        value.sum().backward()
        results.append({'value': value.detach(), 'gx': x.grad, 'gy': y.grad})
    torch.save({'errors': errors, 'layout': layout, 'results': results}, pathlib.Path(out_dir) / f'sp{mesh.rank()}.pt')
