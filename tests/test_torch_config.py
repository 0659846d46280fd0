"""``--config``/``--preset`` and the launcher on the CPU: every preset,
against each of the five trainers' parsers, resolves in the port
(``config.parse_with_config``) to what the JAX package's
``parse_with_config`` gives against the JAX trainer's parser, or exits as it
does (``vae-lap`` and the FAUST presets name keys some tasks lack); JSON
over preset and flags over JSON; an unknown key; the one difference the
port keeps on purpose (a value its parser limits by ``choices``, the ARAP
models' ``dirac``, stops in the parser); the parser's defaults untouched
after a layered parse; ``dump_config``; a trainer run from a preset;
``launch.build_command`` as ``tests/test_config_viz.py`` checks the JAX
package's, with ``--platform cpu`` and ``--devices``."""

import copy
import importlib
import json
import sys

import pytest

from surfacenetworks_tpu import config as jconfig
from surfacenetworks_tpu_torch import config
from surfacenetworks_tpu_torch.cli import launch

TRAINERS = ["train_normal", "train_mnist", "train_vae", "train_arap", "train_correspondence"]
PORT_ONLY = {"device"}


def _parsers(name):
    """Copies of both trainers' parsers: the JAX package's layered parse
    leaves the preset on the parser it is given."""
    jparser = importlib.import_module(f"surfacenetworks_tpu.cli.{name}").parser
    tparser = importlib.import_module(f"surfacenetworks_tpu_torch.cli.{name}").parser
    return copy.deepcopy(jparser), tparser


def _resolve(fn, parser, argv):
    """The values that differ from the parser's own defaults (the port's
    result directories differ from the JAX package's), or the exit's
    message."""
    defaults = vars(copy.deepcopy(parser).parse_args([]))
    try:
        ns = vars(fn(parser, argv))
    except SystemExit as e:
        return ("exit", str(e))
    return {k: v for k, v in ns.items() if k not in PORT_ONLY and v != defaults[k]}


def test_presets_are_the_jax_package_s():
    assert config.PRESETS == jconfig.PRESETS


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
@pytest.mark.parametrize("name", TRAINERS)
def test_preset_resolves_as_in_jax(name, preset):
    jparser, tparser = _parsers(name)
    ref = _resolve(jconfig.parse_with_config, jparser, ["--preset", preset])
    if name == "train_arap" and isinstance(ref, dict) and ref.get("model") == "dirac":
        # JAX's ARAP trainer parses this and fails at MODELS["dirac"]; the
        # port's parser has no such choice, so it fails there
        with pytest.raises(SystemExit) as e:
            config.parse_with_config(tparser, ["--preset", preset])
        assert e.value.code == 2
        return
    got = _resolve(config.parse_with_config, tparser, ["--preset", preset])
    assert got == ref
    if name == "train_vae" and preset == "vae-lap":
        assert got == ("exit", "config keys not recognized by this task: ['kld_warmup', 'latent']")


@pytest.mark.parametrize("name", TRAINERS)
def test_json_over_preset_and_flags_over_json(name, tmp_path):
    preset = {"train_normal": "normal-lap", "train_mnist": "mnist-lap", "train_vae": "mnist-lap",
              "train_arap": "arap-lap", "train_correspondence": "faust-lap"}[name]
    path = tmp_path / "run.json"
    path.write_text(json.dumps({"num_epoch": 3, "seed": 5, "lr": 0.5 if name != "train_correspondence" else "0.5"}))
    argv = ["--preset", preset, "--config", str(path), "--num-epoch", "7"]
    jparser, tparser = _parsers(name)
    ref = _resolve(jconfig.parse_with_config, jparser, argv)
    got = _resolve(config.parse_with_config, tparser, argv)
    assert got == ref
    assert got["num_epoch"] == 7 and got["seed"] == 5 and got["preset"] == preset and got["config"] == str(path)
    assert float(got["lr"]) == 0.5  # the file over the preset's 1e-3
    # the port's parser keeps its own defaults for the next parse
    assert vars(tparser.parse_args([]))["num_epoch"] == tparser.get_default("num_epoch") != 3


@pytest.mark.parametrize("name", TRAINERS)
def test_unknown_config_key_exits_as_jax(name, tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"lr": 0.1, "bogus_key": 1}))
    jparser, tparser = _parsers(name)
    ref = _resolve(jconfig.parse_with_config, jparser, ["--config", str(path)])
    got = _resolve(config.parse_with_config, tparser, ["--config", str(path)])
    assert got == ref == ("exit", "config keys not recognized by this task: ['bogus_key']")


def test_dump_config_writes_the_resolved_run(tmp_path):
    from surfacenetworks_tpu_torch.cli import common, train_normal

    args = config.parse_with_config(train_normal.parser, ["--preset", "normal-lap"])
    path = tmp_path / "cfg" / "run.json"
    common.dump_config(args, str(path))
    data = json.loads(path.read_text())
    assert common.dump_config is config.dump_config
    assert data["batch_size"] == 32 and data["model"] == "lap" and data["preset"] == "normal-lap"


def test_trainer_runs_from_a_preset(tmp_path):
    """The normal trainer from ``--preset normal-lap`` with its heavy knobs
    cut by flags, which win: the log records the preset's other values."""
    from surfacenetworks_tpu_torch.cli import train_normal

    hist = train_normal.main(["--preset", "normal-lap", "--device", "cpu", "--data-path", "tests/fixtures/objs",
                              "--layer", "2", "--batch-size", "2", "--num-updates", "2", "--num-epoch", "1",
                              "--result-dir", str(tmp_path)])
    assert len(hist["train"]) == 1
    cfg = json.loads((tmp_path / "cfg" / "debug.json").read_text())
    assert cfg["half_lr"] == 20 and cfg["optimizer"] == "adam" and cfg["layer"] == 2 and cfg["batch_size"] == 2


def test_launcher_builds_command():
    args = launch.parser.parse_args(["--task", "normal", "--model", "dirac", "--layer", "3", "--dry-run"])
    cmd, env = launch.build_command(args)
    assert cmd[:3] == [sys.executable, "-m", "surfacenetworks_tpu_torch.cli.train_normal"]
    assert "--model" in cmd and "dirac" in cmd and "--device" not in cmd
    assert cmd[cmd.index("--result-prefix") + 1] == "normal_dirac_3"


@pytest.mark.parametrize("task", sorted(launch.TASKS))
def test_launcher_names_the_port_s_trainers(task):
    args = launch.parser.parse_args(["--task", task, "--preset", "mnist-lap", "--platform", "cpu", "--devices", "1,2",
                                     "--dry-run", "--", "--num-epoch", "1"])
    cmd, env = launch.build_command(args)
    assert cmd[2] == f"surfacenetworks_tpu_torch.cli.{launch.TASKS[task].rsplit('.', 1)[1]}"
    assert cmd[cmd.index("--device") + 1] == "cpu" and cmd[-2:] == ["--num-epoch", "1"]
    assert env["CUDA_VISIBLE_DEVICES"] == "1,2"
    assert launch.main(["--task", task, "--dry-run"]) == 0


def test_faust_dirac_takes_the_dir_trunk():
    """``--preset faust-dirac`` sets ``model: dirac``, which the FAUST
    trainer reads as the dir trunk over the Dirac tables, as the JAX
    trainer's operator key does."""
    from surfacenetworks_tpu_torch.cli import train_correspondence as ttrain
    from surfacenetworks_tpu_torch.models.correspondence import TRUNKS

    args = config.parse_with_config(ttrain.parser, ["--preset", "faust-dirac", "--device", "cpu", "--datapath",
                                                    "tests/fixtures/faust", "--layer", "2"])
    assert args.model == "dirac" and ttrain.model_key_of(args.model) == "dirac"
    trainer = ttrain.CorrespondenceTrainer(args, log=lambda _: None)
    assert trainer.model_key == "dirac" and type(trainer.model.trunk) is TRUNKS["dir"]
