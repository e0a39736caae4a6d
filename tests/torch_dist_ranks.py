"""What each rank of the distributed CPU tests runs (tests/test_torch_port_dist.py,
tests/test_torch_port_sp.py, tests/test_torch_port_tp.py, tests/test_torch_port_ep.py,
tests/test_torch_port_pp.py).

A plain module, free of JAX, so that the spawned gloo ranks import only
torch and pccf_torch: :func:`train_cases` takes training steps from a
payload the test wrote and saves each rank's results; :func:`hook_cases`
runs the codebook hook and a stage-1 ``fit`` with early stopping and
checkpoints under two ranks; :func:`sp_cases` runs the sharded-point-axis
losses on four; :func:`tp_cases`, :func:`ep_cases` and :func:`pp_cases`
tensor, expert and pipeline parallelism on four.
"""

from __future__ import annotations

import dataclasses
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


def _barrier() -> None:
    torch.distributed.all_reduce(torch.zeros(1))


def _counts(optimizer) -> list[float]:
    return [float(s['step']) for s in optimizer.state.values() if 'step' in s]


def _layout(trainer) -> dict:
    """Each sharded slice's shape, its one-device shape and its moments'
    shapes."""
    from pccf_torch.dist import tp

    shards = tp.layouts(trainer.model)
    out = {}
    for name, p in trainer.model.named_parameters():
        key = tp.one_device_name(name)
        if key in shards:
            state = trainer.optimizer.state.get(p, {})
            out[key] = {'slice': tuple(p.shape), 'full': shards[key].shape,
                        'moments': [tuple(v.shape) for k, v in state.items() if k != 'step']}
    return out


def _gathered_grads(trainer) -> dict:
    """A TP trainer's gradients in the one-device layout, each slice gathered
    (a collective: every rank calls it)."""
    from pccf_torch.dist import tp

    grads = {}
    for n, p in trainer.model.named_parameters():
        if p.grad is not None:
            key = tp.one_device_name(n)
            grads[key] = trainer.shards[key].full(p.grad) if key in trainer.shards else p.grad.clone()
    return grads


def tp_cases(payload: str, out_dir: str) -> None:
    """Tensor parallelism on a 2 x 2 grid (tests/test_torch_port_tp.py):
    the probe step (its gradients gathered), three ``TPTrainer`` steps and an
    epoch, checkpoints both ways, the weights-only resumes, and the eval
    forward; this rank's results to ``out_dir/tp<r>.pt``."""
    from pccf_torch.dist import make_2d_grid, shard_params_tp, tp
    from pccf_torch.experiment import Experiment
    from pccf_torch.models import build_vqvae
    from pccf_torch.train import Trainer, TPTrainer, get_autoencoder_loss, tp_state, tp_train_step
    from pccf_torch.train.autoencoder import CloudLoader
    from pccf_torch.train.checkpoint import Checkpoint

    case = torch.load(payload, weights_only=False)
    cfg, spe = case['config'], case['steps_per_epoch']
    grid = make_2d_grid(4, mp=2)
    tcfg, loss = cfg.autoencoder.train, get_autoencoder_loss(cfg)

    def model():
        m = build_vqvae(cfg)
        m.load_state_dict(case['state'])
        return m

    def trainer(**kw):
        return Trainer(model(), loss, tcfg, spe, seed=0, **kw)

    inputs, targets, noise = case['batch']
    metrics, probe = tp_train_step(trainer(), grid, inputs, targets, noise, epoch=1.0, min_size=32, return_state=True)
    out = {'probe': {'metrics': metrics, 'state': tp.one_device_state(probe.model), 'layout': _layout(probe),
                     'grads': _gathered_grads(probe)}}

    # TPTrainer: persistent state over three steps (the trainer's own draws), then an epoch
    tpt = TPTrainer(model(), loss, tcfg, spe, grid, seed=3, min_size=32)
    losses = [float(tpt.run_step(inputs, targets, epoch=1.0)['Loss']) for _ in range(3)]
    loader = CloudLoader(inputs.cloud, cfg.autoencoder.train.batch_size)
    tpt.train_until(loader, 1)
    out['trainer'] = {'losses': losses, 'step': tpt.step, 'epoch_loss': tpt.metrics_log[-1]['Loss'],
                      'layout': _layout(tpt)}

    # checkpoints: TP -> TP, TP -> one device, one device -> TP
    with Experiment(cfg, name='tp-ckpt', par_dir=case['exp_dir']).create_run(record=mesh.is_main_process()):
        tpt.save_checkpoint()
        _barrier()
        saved = tpt.optimizer_state()
        again = TPTrainer(model(), loss, tcfg, spe, grid, seed=3, min_size=32)
        again.load_checkpoint()
        restored = again.optimizer_state()
        same_moments = all(torch.equal(a, b) for i in saved['optimizer']['state']
                           for a, b in zip(saved['optimizer']['state'][i].values(),
                                           restored['optimizer']['state'][i].values()))
        restored_step = again.step
        follow = float(again.run_step(inputs, targets, epoch=2.0)['Loss'])
        one = trainer()
        one.load_checkpoint()
        out['checkpoint'] = {'same_moments': same_moments, 'step': restored_step, 'follow_loss': follow,
                             'layout': _layout(again), 'weights': tp.one_device_state(tpt.model),
                             'one_device': {k: v.clone() for k, v in one.model.state_dict().items()},
                             'one_device_moments': [v['exp_avg'].clone() for v in one.optimizer.state.values()],
                             'tp_moments': [v['exp_avg'] for v in saved['optimizer']['state'].values()]}
    with Experiment(cfg, name='one-ckpt', par_dir=case['exp_dir']).create_run(record=mesh.is_main_process()):
        one = trainer()
        one.run_step(inputs, targets, noise, epoch=1.0)
        one.epoch = 1
        one.save_checkpoint()
        _barrier()
        under = TPTrainer(model(), loss, tcfg, spe, grid, min_size=32)
        under.load_checkpoint()
        shards, one_state = tp.layouts(under.model), one.model.state_dict()
        equal = {}
        for n, p in under.model.named_parameters():
            key = tp.one_device_name(n)
            equal[key] = torch.equal(p.detach(), shards[key].take(one_state[key]) if key in shards else one_state[key])
        out['from_one_device'] = {'equal': equal, 'sharded': len(shards), 'step': under.step, 'step_one': one.step}
    # a resume from weights alone at epoch 5
    with Experiment(cfg, name='weights-only', par_dir=case['exp_dir']).create_run(record=mesh.is_main_process()):
        if mesh.is_main_process():
            Checkpoint(type(model()).__name__).save(model(), 5)
        _barrier()
        resumed = TPTrainer(model(), loss, tcfg, spe, grid, min_size=32)
        resumed.load_checkpoint()
        out['resume'] = {'step': resumed.step, 'counts': _counts(resumed.optimizer)}
    base = trainer()
    base.epoch = 4
    probe = tp_state(base, grid, min_size=32)
    out['probe_resume'] = {'step': probe.step, 'counts': _counts(probe.optimizer), 'expected': 4 * spe}

    # the gradient operations on the sharded gradients: each one's output gathered to the one-device layout
    out['grad_ops'] = {}
    for op in case['grad_ops']:
        t = TPTrainer(model(), loss, dataclasses.replace(tcfg, grad_op=op), spe, grid, min_size=32)
        t.run_step(inputs, targets, noise, epoch=1.0)
        out['grad_ops'][op] = _gathered_grads(t)

    # the eval forward, this rank's rows of the batch
    m = model().eval()
    shard_params_tp(m, grid, min_size=32)
    rows = inputs.cloud.shape[0] // grid.dp
    lo = grid.index('dp') * rows
    part = type(inputs)(inputs.cloud[lo:lo + rows], None, inputs.initial_sampling[lo:lo + rows])
    with torch.no_grad(), torch.nn.utils.parametrize.cached():
        out['eval'] = {'recon': m(part).recon, 'rows': (lo, rows)}
    torch.save(out, pathlib.Path(out_dir) / f'tp{mesh.rank()}.pt')


def ep_cases(payload: str, out_dir: str) -> None:
    """Expert parallelism on a 1-D grid of four (tests/test_torch_port_ep.py):
    each case's decoder with its components sharded, its eval forward (the
    calls of the partial mode counted) and the gradient of a loss of it;
    this rank's results to ``out_dir/ep<r>.pt``."""
    from pccf_torch.dist import make_2d_grid, shard_variables_ep
    from pccf_torch.kernels import api

    grid = make_2d_grid(mesh.world_size(), mp=mesh.world_size())
    partial = api.pcgen_partial
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return partial(*args, **kwargs)

    api.pcgen_partial = counted
    results = []
    try:
        for case in torch.load(payload, weights_only=False):
            dec = case['decoder']
            sharded = shard_variables_ep(dec, grid, n_components=dec.n_components)
            dec.eval()
            w, samp, target = case['w'], case['samp'], case['target']
            del calls[:]
            with torch.no_grad():
                recon = dec(w, samp)
            res = {'recon': recon, 'partial_calls': len(calls), 'sharded': sharded, 'g0': dec.ep.g0,
                   'count': dec.ep.count,
                   'shapes': {k: tuple(v.shape) for k, v in [*dec.named_parameters(), *dec.named_buffers()]}}
            if case['grad']:
                value = torch.mean((dec(w, samp) - target) ** 2)
                value.backward()
                res.update(value=float(value),
                           grads={k: p.grad.clone() for k, p in dec.named_parameters() if p.grad is not None})
            results.append(res)
    finally:
        api.pcgen_partial = partial
    torch.save(results, pathlib.Path(out_dir) / f'ep{mesh.rank()}.pt')


def pp_cases(payload: str, out_dir: str) -> None:
    """Pipeline parallelism (tests/test_torch_port_pp.py) on the 1-D grids of
    four and of two stages (ranks 2 and 3 outside the latter): each case's
    output and, where asked, its stage's gradients; this rank's results to
    ``out_dir/pp<r>.pt``."""
    from torch.func import functional_call

    from pccf_torch.dist import make_2d_grid, pipeline_apply, shard_stacked_params, stack_layer_params

    cases = torch.load(payload, weights_only=False)
    grids = {4: make_2d_grid(4, mp=4), 2: make_2d_grid(2, mp=2)}
    results = []
    for case in cases:
        grid = grids[case['stages']]
        if grid.rank is None:
            results.append(None)
            continue
        layer = case['layer']
        stacked = stack_layer_params(case['params'])

        def layer_fn(p, h, *memory):
            return functional_call(layer, p, (h, *memory))

        res = {}
        try:
            if case.get('train'):
                stage = shard_stacked_params(stacked, grid)
                for v in stage.layers.values():
                    v.requires_grad_(True)
                x = case['x'].clone().requires_grad_(True)
                outp = pipeline_apply(layer_fn, stage, x, grid, n_micro=case['n_micro'])
                value = torch.mean((outp - case['target']) ** 2)
                value.backward()
                res = {'value': float(value), 'out': outp.detach(), 'first': stage.first, 'count': stage.count,
                       'grads': {k: v.grad.clone() for k, v in stage.layers.items()}, 'dx': x.grad.clone()}
            else:
                with torch.no_grad():
                    res = {'out': [pipeline_apply(layer_fn, stacked, case['x'], grid, n_micro=m,
                                                  extra=case.get('extra')) for m in case['n_micro']]}
        except ValueError as e:
            res = {'error': str(e)}
        results.append(res)
    torch.save(results, pathlib.Path(out_dir) / f'pp{mesh.rank()}.pt')


def tp_ep_pp_cases(tp_payload: str | None, ep_payload: str | None, pp_payload: str | None, out_dir: str) -> None:
    """Whichever of :func:`tp_cases`, :func:`ep_cases`, :func:`pp_cases` has a payload."""
    for fn, payload in ((tp_cases, tp_payload), (ep_cases, ep_payload), (pp_cases, pp_payload)):
        if payload is not None:
            fn(payload, out_dir)
