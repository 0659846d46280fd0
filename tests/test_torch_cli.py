"""The port's trainers take every command line the JAX package's take: each
flag of a JAX trainer's parser is accepted by the port's, which runs it or
refuses it by name ("not ported yet"); and the JAX FAUST command lines of
``tests/test_streaming_head.py`` parse with the port's parser, where
``--batch-size`` and ``--num-vertices`` are read by neither trainer and
``--no-epoch-scan`` is the order the port always runs.  ``--bf16`` is run,
not refused, by all five."""

import importlib

import pytest

TRAINERS = ["train_correspondence", "train_normal", "train_arap", "train_mnist", "train_vae"]
PORT_ONLY = {"--device"}  # the one flag the port adds: cuda unless told otherwise


def _options(parser) -> set:
    return {o for action in parser._actions for o in action.option_strings}


@pytest.mark.parametrize("name", TRAINERS)
def test_port_parser_accepts_every_jax_flag(name):
    jax_parser = importlib.import_module(f"surfacenetworks_tpu.cli.{name}").parser
    port_parser = importlib.import_module(f"surfacenetworks_tpu_torch.cli.{name}").parser
    jax_flags, port_flags = _options(jax_parser), _options(port_parser)
    assert not jax_flags - port_flags, f"{name}: the port's parser lacks {sorted(jax_flags - port_flags)}"
    assert port_flags - jax_flags <= PORT_ONLY, f"{name}: flags the JAX trainer lacks {sorted(port_flags - jax_flags)}"


# the JAX FAUST command lines of tests/test_streaming_head.py:92-124
JAX_FAUST_LINES = [
    ["--synthetic", "3", "--layer", "2", "--num-epoch", "1", "--num-updates", "3", "--num-vertices", "300",
     "--streaming-head", "--graph-parallel", "2", "--deser-option", "no", "--result-dir", "r"],
    ["--synthetic", "3", "--layer", "2", "--num-epoch", "1", "--num-updates", "4", "--num-vertices", "300",
     "--streaming-head", "--deser-option", "no", "--result-dir", "r"],
    ["--synthetic", "2", "--loss", "sl1", "--streaming-head", "--num-vertices", "300", "--deser-option", "no",
     "--result-dir", "r"],
]


@pytest.mark.parametrize("line", range(len(JAX_FAUST_LINES)))
def test_jax_faust_command_lines_parse(line):
    """Each line parses to what the JAX parser makes of it, and the port
    refuses by name exactly what it does not run (graph-parallel) and
    nothing else; the sl1 loss with the streaming head exits as the JAX
    trainer does (the streaming head is dcel's only)."""
    from surfacenetworks_tpu.cli import train_correspondence as jtrain
    from surfacenetworks_tpu_torch.cli import train_correspondence as ttrain

    argv = JAX_FAUST_LINES[line] + ["--batch-size", "2", "--no-epoch-scan"]
    got, ref = vars(ttrain.parser.parse_args(argv)), vars(jtrain.parser.parse_args(argv))
    for key in ("synthetic", "layer", "num_epoch", "num_updates", "num_vertices", "batch_size", "no_epoch_scan",
                "streaming_head", "graph_parallel", "loss", "deser_option"):
        assert got[key] == ref[key], key
    args = ttrain.parser.parse_args(argv)
    if "--graph-parallel" in argv:
        with pytest.raises(SystemExit, match="not ported yet: --graph-parallel"):
            ttrain.refuse_unported(args)
    else:
        ttrain.refuse_unported(args)
    if "sl1" in argv:
        with pytest.raises(SystemExit, match="--streaming-head supports --loss dcel only"):
            ttrain.CorrespondenceTrainer(ttrain.parser.parse_args(argv + ["--device", "cpu"]), log=lambda _: None)


@pytest.mark.parametrize("flag", [["--config", "c.json"], ["--preset", "faust"]])
def test_train_correspondence_refuses_config_flags(flag):
    from surfacenetworks_tpu_torch.cli import train_correspondence as ttrain

    with pytest.raises(SystemExit, match="not ported yet: --config and --preset"):
        ttrain.refuse_unported(ttrain.parser.parse_args(flag))


@pytest.mark.parametrize("name", TRAINERS)
def test_bf16_is_not_refused(name):
    """``--bf16`` (mixed precision) is on no trainer's refused list, while a
    flag that is still refused is, by name, in the same call."""
    mod = importlib.import_module(f"surfacenetworks_tpu_torch.cli.{name}")
    refuse = mod.refuse_unported if name not in ("train_mnist", "train_vae") else (
        lambda args: mod.refuse_unported(args, name))
    args = mod.parser.parse_args(["--bf16"])
    assert args.bf16
    refuse(args)
    with pytest.raises(SystemExit, match="not ported yet: --config and --preset"):
        refuse(mod.parser.parse_args(["--bf16", "--config", "c.json"]))
