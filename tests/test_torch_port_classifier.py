"""The classifier's stage of pccf_torch against the JAX package, on the CPU.

The classification objectives and the running metric state; the DGCNN
classifier's training forward and three SGD steps against
``pccf.train.Trainer`` (the same flax weights, batch and schedule; dropout 0
on both sides, since the two packages draw their masks from different
generators); the port's dropout alone against its keep rate and scale; the
copied augmentations and the training batch they make against
``pccf/data/modelnet.py``'s numpy path; and the entry point at a tiny size.
Inputs are made with numpy from a seed.

Tolerances: the objectives 1e-6 (float32 log-softmax and means, the running
sums in float64 on both sides); the train-mode logits 1e-4; losses 1e-4
relative and every parameter and BatchNorm statistic after each step rel-L2
1e-4 per tensor (float32 chains: the kNN graphs, max-pools and sum-pools of
the streaming BatchNorm are built by each side, SGD moves each element by
``lr · g``); the augmentations bit-equal (the same numpy draws in the same
order).
"""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.config import get_config_all
from pccf.data.structures import Inputs as JInputs, Targets as JTargets
from pccf.kernels import api as japi
from pccf_torch import config as tc
from pccf_torch.convert import flax_to_state_dict
from pccf_torch.data.structures import Inputs, Targets

from tests.test_torch_port_modules import load_port, randomize_stats

torch.set_num_threads(1)

N_POINTS, N_CLASSES, BATCH = 256, 3, 4
OVERRIDES = [
    'classifier.model.n_neighbors=6',
    'classifier.model.conv_dims=[8,16]',
    'classifier.model.mlp_dims=[32,16]',
    'classifier.model.feature_dim=32',
    'classifier.model.dropout_rates=[0,0]',
    f'classifier.train.batch_size={BATCH}',
]
STEPS_PER_EPOCH = 2  # the third step is in epoch 1: the cosine schedule lowers the lr


def port_config(dropout=(0.0, 0.0)) -> tc.SliceConfig:
    return tc.SliceConfig(
        data=tc.DataConfig(n_input_points=N_POINTS, n_target_points=N_POINTS, n_classes=N_CLASSES),
        classifier=tc.ClassifierConfig(n_neighbors=6, conv_dims=(8, 16), feature_dim=32, mlp_dims=(32, 16),
                                       dropout_rates=dropout, train=tc.ClassifierTrainConfig(batch_size=BATCH)),
    )


def _clouds(n, seed, points=N_POINTS):
    return (np.random.default_rng(seed).standard_normal((n, points, 3)) / 2).astype(np.float32)


def _logits(n, seed):
    return (np.random.default_rng(seed).standard_normal((n, N_CLASSES)) * 2).astype(np.float32)


# ------------------------------------------------------------ objectives


def _batches():
    """Logits and labels in batches of 4, 4 and a last partial batch of 3;
    the second batch has no sample of class 2."""
    labels = np.asarray([0, 1, 2, 2, 0, 1, 1, 0, 2, 1, 0])
    logits = _logits(len(labels), 1)
    logits[5, 1] = logits[5].max() + 1.0  # one sure hit in the class-2-free batch
    return [(logits[s], labels[s]) for s in (slice(0, 4), slice(4, 8), slice(8, 11))]


@pytest.mark.parametrize('name', ['get_cross_entropy_loss', 'get_accuracy', 'get_macro_accuracy', 'get_f1',
                                  'get_classification_loss'])
def test_classification_objectives_match_jax(name):
    """Per-batch values and the pass's running means, weighted by batch
    size: the macro accuracy is a recall over the classes present in each
    batch, averaged over batches (not the dataset's macro recall)."""
    import pccf.train.losses as jlosses
    import pccf_torch.train.losses as tlosses

    jobj, tobj = getattr(jlosses, name)(), getattr(tlosses, name)()
    assert tobj.name == jobj.name and tobj.higher_is_better == jobj.higher_is_better
    for logits, labels in _batches():
        jloss, jm = jobj.loss_and_metrics(jnp.asarray(logits), JTargets(ref_cloud=None, label=jnp.asarray(labels)))
        tloss, tm = tobj.loss_and_metrics(torch.from_numpy(logits), Targets(ref_cloud=None,
                                                                            label=torch.from_numpy(labels)))
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6, atol=1e-6)
        for key, value in jm.items():
            np.testing.assert_allclose(float(tm[key]), float(value), rtol=1e-6, atol=1e-6, err_msg=key)
        jobj.update_state(jm, len(labels))
        tobj.update_state(tm, len(labels))
    want = jobj.compute_metrics()
    got = tobj.compute_metrics()
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-6, abs=1e-6), key
    if name == 'get_macro_accuracy':  # the mean of per-batch recalls, not the dataset's macro recall
        logits = np.concatenate([lg for lg, _ in _batches()])
        labels = np.concatenate([lb for _, lb in _batches()])
        hits = logits.argmax(1) == labels
        dataset_macro = np.mean([hits[labels == c].mean() for c in range(N_CLASSES)])
        assert abs(got['Macro Accuracy'] - dataset_macro) > 1e-3


def _state(objective_module, seed):
    """A classification objective with a running state of two batches."""
    obj = objective_module.get_classification_loss()
    for k, (logits, labels) in enumerate(_batches()[:2]):
        obj.update_state({'Accuracy': float(seed + k) / 10, 'CrossEntropy': 1.0 + seed + k}, len(labels))
    return obj


def test_copy_keeps_the_running_state_and_merge_state_matches_jax():
    """``copy`` keeps the state, as the suites' ``merged = test.objective.copy()``
    needs (``evaluate_counterfactuals.py:79``); ``merge_state`` adds
    another's sums and counts; ``compute_metrics`` reads the merged means."""
    import pccf.train.losses as jlosses
    import pccf.train.objectives as jobjectives
    import pccf_torch.train.losses as tlosses
    import pccf_torch.train.objectives as tobjectives

    results = []
    for losses, objectives in ((jlosses, jobjectives), (tlosses, tobjectives)):
        first, second = _state(losses, 1), _state(losses, 5)
        copied = first.copy()
        assert copied.compute_metrics() == first.compute_metrics() != {}
        assert copied.higher_is_better == first.higher_is_better
        copied.merge_state(second)
        results.append((objectives.compute_metrics(copied), first.compute_metrics()))
    (jmerged, jfirst), (tmerged, tfirst) = results
    assert tfirst == jfirst and tmerged == pytest.approx(jmerged, rel=1e-12)
    assert tmerged['Accuracy'] == pytest.approx((0.1 + 0.2 + 0.5 + 0.6) / 4)


def test_algebra_starts_empty_and_keeps_higher_is_better():
    from pccf_torch.train.losses import get_accuracy, get_cross_entropy_loss

    acc = get_accuracy()
    acc.update_state({'Accuracy': 1.0}, 3)
    joined = get_cross_entropy_loss() | acc
    assert joined.compute_metrics() == {} and joined.higher_is_better == {'Accuracy': True}
    assert (2.0 * get_cross_entropy_loss()).higher_is_better == {}


def test_trainer_and_test_start_from_an_empty_state():
    """Both runners copy the objective and clear the copy's state, so a state
    the caller's objective holds never reaches their metrics."""
    from pccf_torch.nn import ClassifierTrainModule, build_classifier
    from pccf_torch.nn.layers import init_from_seed
    from pccf_torch.train import Loader, Test, Trainer, get_classification_loss
    from pccf_torch.data.clouds import LabelledClouds

    cfg = port_config()
    model = ClassifierTrainModule(build_classifier(cfg))
    init_from_seed(model, 0)
    loss = get_classification_loss()
    loss.update_state({'CrossEntropy': 100.0, 'Bogus': 1.0}, 50)
    trainer = Trainer(model, loss, cfg.classifier.train, 1)
    test = Test(model, Loader(LabelledClouds(torch.from_numpy(_clouds(5, 3)), torch.arange(5) % 3), 4), loss)
    assert trainer.objective.compute_metrics() == {} and test.objective.compute_metrics() == {}
    assert loss.compute_metrics()['Bogus'] == 1.0  # the caller's own state is untouched
    metrics = test()
    assert set(metrics) == {'CrossEntropy', 'Accuracy', 'Macro Accuracy'} and metrics['CrossEntropy'] < 100.0


# ------------------------------------------------------- the classifier


def _jax_pair(seed, dropout=(0.0, 0.0)):
    """A flax DGCNN classifier with random weights and BatchNorm statistics,
    and the port's with the same weights."""
    from pccf.nn.classifier import DGCNNClassifier
    from pccf.nn.layers import default_act
    from pccf_torch.nn import build_classifier

    cls = DGCNNClassifier(n_classes=N_CLASSES, n_neighbors=6, conv_dims=(8, 16), feature_dim=32, mlp_dims=(32, 16),
                          dropout_rates=dropout, act=default_act)
    v = randomize_stats(cls.init(jax.random.key(seed), JInputs(cloud=jnp.asarray(_clouds(2, seed)))), seed=seed)
    return cls, v, load_port(build_classifier(port_config(dropout)), v)


def test_train_forward_matches_jax():
    """``train=True``: EdgeConv on the streaming-BN path, ``final_conv`` and
    the head's BatchNorm on batch statistics; the logits and every updated
    running statistic."""
    cls, v, port = _jax_pair(3)
    cloud = _clouds(BATCH, 4)
    with japi.force_backend('jnp'):
        want, updates = cls.apply(v, JInputs(cloud=jnp.asarray(cloud)), train=True, mutable=['batch_stats'],
                                  rngs={'dropout': jax.random.key(0)})
    port.train()
    got = port(Inputs(cloud=torch.from_numpy(cloud)), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    stats = flax_to_state_dict({'batch_stats': jax.device_get(updates['batch_stats'])})
    state = port.state_dict()
    assert stats and all(np.allclose(state[k].numpy(), s.numpy(), rtol=1e-4, atol=1e-5) for k, s in stats.items())


def test_head_dropout_keep_rate_and_scale():
    """In training the head drops before its second block at the first rate
    (0.5): kept elements scaled by 1 / (1 - 0.5), about half kept, the masks
    from the caller's generator (the same seed, the same masks); in eval no
    element drops."""
    from pccf_torch.nn.layers import MLPHead, default_act

    head = MLPHead(64, (512, 256), 3, default_act, (0.5, 0.5))
    seen = []
    handle = head.blocks[1].register_forward_pre_hook(lambda mod, args: seen.append(args[0].detach().clone()))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 64)).astype(np.float32))
    head.train()
    out1 = head(x, torch.Generator().manual_seed(7))
    out2 = head(x, torch.Generator().manual_seed(7))
    head.eval()
    head(x)
    handle.remove()
    dropped, again, full = seen
    assert torch.equal(full, head.blocks[0](x))
    assert torch.equal(out1, out2) and torch.equal(dropped, again)
    kept = dropped != 0
    assert 0.45 <= float(kept.float().mean()) <= 0.55
    head.train()
    hidden = head.blocks[0](x)  # batch statistics again: the same hidden values
    assert torch.allclose(dropped[kept], 2.0 * hidden[kept], rtol=1e-6)
    with pytest.raises(ValueError, match='explicit torch.Generator'):
        head.train()(x)


def test_three_sgd_steps_match_jax():
    """Three steps of the classifier (cross entropy | accuracy | macro
    accuracy; SGD at 0.01 under the cosine schedule restarting over 45
    epochs, epochs of 2 steps) against the JAX Trainer's jitted step:
    metrics, every parameter and running statistic after every step."""
    from pccf.dist import get_mesh
    from pccf.train import Model, Trainer as JTrainer, get_classification_loss as jloss, get_learning_schema
    from pccf_torch.nn import ClassifierTrainModule
    from pccf_torch.train import Trainer, get_classification_loss

    cfg = get_config_all(OVERRIDES)
    cls, v, port = _jax_pair(6)
    loader = types.SimpleNamespace(batch_size=BATCH, n_batches=lambda inference=False: STEPS_PER_EPOCH)
    jtrainer = JTrainer(Model(cls, 'cls', variables=v), loader, jloss(), get_learning_schema(cfg.classifier),
                        mesh=get_mesh(1))
    pcfg = port_config().classifier.train
    trainer = Trainer(ClassifierTrainModule(port), get_classification_loss(), pcfg, STEPS_PER_EPOCH, seed=7)
    assert isinstance(trainer.optimizer, torch.optim.SGD) and trainer.grad_op is None
    assert trainer.lr_at(0) == pytest.approx(0.01) and trainer.lr_at(2) < trainer.lr_at(0)
    for step in range(3):
        cloud, labels = _clouds(BATCH, 20 + step), np.asarray([0, 1, 2, step % 3])
        with japi.force_backend('jnp'):
            want = jtrainer.run_step(JInputs(cloud=cloud), JTargets(ref_cloud=cloud, label=labels))
        got = trainer.run_step(Inputs(torch.from_numpy(cloud)), Targets(torch.from_numpy(cloud),
                                                                        torch.from_numpy(labels)))
        assert set(got) == set(want) == {'CrossEntropy', 'Accuracy', 'Macro Accuracy'}
        for name, value in want.items():
            np.testing.assert_allclose(float(got[name]), value, rtol=1e-4, atol=1e-6, err_msg=(step, name))
        state = jax.device_get(jtrainer.state)
        after = port.state_dict()
        for name, value in flax_to_state_dict({'params': state.params, 'batch_stats': state.batch_stats}).items():
            rel = np.linalg.norm(after[name].numpy() - value.numpy()) / (np.linalg.norm(value.numpy()) + 1e-30)
            assert rel <= 1e-4, (step, name, rel)


def test_optimizer_by_name():
    """AdamW for the autoencoders as before, SGD for the classifier, and any
    other name refused."""
    import dataclasses

    from pccf_torch.train.runners import make_optimizer

    p = [torch.nn.Parameter(torch.ones(3))]
    adamw = make_optimizer(tc.AutoEncoderTrainConfig(), p, 0.1)
    assert isinstance(adamw, torch.optim.AdamW)
    assert adamw.defaults['weight_decay'] == 0.001 and adamw.defaults['eps'] == 1e-8
    assert isinstance(make_optimizer(tc.WAutoEncoderTrainConfig(), p, 0.1), torch.optim.AdamW)
    sgd = make_optimizer(tc.ClassifierTrainConfig(), p, 0.1)
    assert isinstance(sgd, torch.optim.SGD) and sgd.defaults['momentum'] == 0.0
    with pytest.raises(ValueError, match='not ported'):
        make_optimizer(dataclasses.replace(tc.ClassifierTrainConfig(), optimizer_name='RMSprop'), p, 0.1)


def test_classifier_config_matches_composed_yaml():
    """The classifier's training settings, dropout, the augmentations and
    the suites' counterfactual value against ``get_config_all([])``."""
    from pccf.config.options import Schedulers

    cfg, port = get_config_all([]), tc.SliceConfig()
    m, t, learn = cfg.classifier.model, cfg.classifier.train, cfg.classifier.train.learn
    pc = port.classifier
    assert pc.dropout_rates == tuple(m.dropout_rates)
    pt = pc.train
    assert (pt.batch_size, pt.n_epochs, pt.optimizer_name, pt.learning_rate) == (
        t.batch_size, t.n_epochs, learn.optimizer_name, learn.learning_rate)
    assert learn.opt_settings == {'weight_decay': pt.weight_decay} and pt.momentum == 0.0
    assert learn.grad_op is None and pt.grad_op is None and str(learn.clip_criterion) == pt.clip_criterion
    sch = learn.scheduler
    assert sch.function == Schedulers.Cosine
    assert (pt.scheduler.restart_interval, pt.scheduler.restart_fraction, pt.scheduler.warmup_steps) == (
        sch.restart_interval, sch.restart_fraction, sch.warmup_steps)
    assert sch.settings == {'min_decay': pt.scheduler.min_decay, 'decay_steps': pt.scheduler.decay_steps}
    d = cfg.data
    assert (port.data.translate, port.data.rotate, port.data.jitter_sigma, port.data.jitter_clip,
            port.data.resample) == (d.translate, d.rotate, d.jitter_sigma, d.jitter_clip, d.resample)
    assert port.user.counterfactual_value == cfg.user.counterfactual_value
    assert port.autoencoder.class_name == cfg.autoencoder.model.class_name
    assert (port.autoencoder.train.optimizer_name, port.w_autoencoder.train.optimizer_name) == (
        cfg.autoencoder.train.learn.optimizer_name, cfg.w_autoencoder.train.learn.optimizer_name)


# -------------------------------------------------------- augmentations


def test_augmentations_copy_matches_the_original():
    """Every function of the copy against ``pccf/data/augmentations.py`` on
    the same seeded numpy input and draws."""
    import pccf.data.augmentations as jaug
    import pccf_torch.data.augmentations as taug

    cloud = _clouds(1, 30)[0] * 3 + 1
    for name in ('normalise',):
        (a, sa), (b, sb) = getattr(jaug, name)(cloud), getattr(taug, name)(cloud)
        assert np.array_equal(a, b) and sa == sb
    assert taug.normalise(np.zeros((5, 3), np.float32))[1] == 1.0
    for mod in (jaug, taug):
        rng = np.random.default_rng(31)
        rot = mod.random_rotation_matrix(rng)
        out = (mod.jitter(rng, cloud, 0.01, 0.02), mod.apply_rotation(cloud, rot),
               *mod.random_scale_translate_params(rng),
               mod.CloudAugmenter(True, True)(rng, [cloud, cloud + 1]), mod.CloudJitterer(0.01, 0.01)(rng, cloud))
        if mod is jaug:
            want = out
    for a, b in zip(want, out):
        if isinstance(a, list):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(a, b)


@pytest.mark.parametrize('rotate,translate', [(False, False), (True, True)])
def test_training_batch_matches_modelnet_numpy_path(rotate, translate):
    """A training batch of the port's labelled clouds against
    ``ModelNet40Split.__getitem__`` (``pccf/data/modelnet.py:85-103``): the
    same draws from a generator seeded as the loader seeds it, in the same
    order; in inference the clouds pass as they are."""
    import dataclasses

    from pccf.data.modelnet import ModelNet40Split
    from pccf_torch.data.clouds import LabelledClouds

    pool = _clouds(6, 40, points=300)
    labels = np.arange(6) % 2
    data = dataclasses.replace(port_config().data, n_input_points=128, rotate=rotate, translate=translate)
    jdata = types.SimpleNamespace(n_input_points=128, resample=False, rotate=rotate, translate=translate,
                                  jitter_sigma=data.jitter_sigma, jitter_clip=data.jitter_clip)
    split = ModelNet40Split(pool, np.zeros((6, 300, 4), np.int32), labels, jdata, seed=0)
    split.set_inference(False)
    split.rng = np.random.default_rng((0, 1, 2))
    want = [split[i] for i in (4, 1, 3)]
    port = LabelledClouds(torch.from_numpy(pool), torch.from_numpy(labels), data=data)
    port.set_inference(False)
    port.rng = np.random.default_rng((0, 1, 2))
    inputs, targets = port.__getitems__([4, 1, 3])
    assert np.array_equal(inputs.cloud.numpy(), np.stack([w[0].cloud for w in want]))
    assert targets.label.tolist() == [int(w[1].label) for w in want]
    port.set_inference(True)
    assert torch.equal(port.__getitems__([2])[0].cloud, torch.from_numpy(pool[2:3]))


def test_loader_seeds_the_augmentations_per_batch():
    """Two epochs draw different batches; the same epoch twice the same."""
    from pccf_torch.data.clouds import LabelledClouds
    from pccf_torch.train import Loader

    data = port_config().data
    loader = Loader(LabelledClouds(torch.from_numpy(_clouds(8, 41)), torch.arange(8) % 2, data=data), 4, seed=3)
    first = [b[0].cloud for b in loader.epoch_iterator(1)]
    again = [b[0].cloud for b in loader.epoch_iterator(1)]
    other = [b[0].cloud for b in loader.epoch_iterator(2)]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[0], other[0])
    assert first[0].shape == (4, N_POINTS, 3)


# ------------------------------------------------------------ entry point


def test_train_classifier_runs_on_the_cpu(capsys):
    """Two epochs at a tiny size with dropout on: a validation pass after
    each, the final test with stored logits, and what the JAX entry point
    prints without trackers."""
    from pccf_torch.nn import build_classifier
    from pccf_torch.nn.layers import init_from_seed
    from pccf_torch.train.classifier import train_classifier

    cfg = port_config(dropout=(0.5, 0.5))
    cls = build_classifier(cfg)
    init_from_seed(cls, 0)
    train, test = torch.from_numpy(_clouds(8, 50)), torch.from_numpy(_clouds(5, 51))
    out = train_classifier(cfg, cls, train, torch.arange(8) % 3, test, torch.tensor([0, 1, 2, 2, 1]), n_epochs=2,
                           device='cpu')
    trainer = out['trainer']
    assert trainer.epoch == 2 and trainer.step == 4 and len(trainer.validation_log) == 2
    assert out['test'] == trainer.validation_log[-1]  # the same weights and batches
    assert out['logits'].shape == (5, N_CLASSES) and np.array_equal(out['predictions'], out['logits'].argmax(1))
    cm = out['confusion_matrix']
    assert cm.shape == (3, 3) and cm.sum() == 5 and np.trace(cm) == 5 - len(out['misclassified'])
    assert out['test']['Accuracy'] == pytest.approx(np.trace(cm) / 5)
    printed = capsys.readouterr().out
    assert "Confusion Matrix for classes ['0', '1', '2']" in printed
    assert f'Misclassified indices: {out["misclassified"]}' in printed
