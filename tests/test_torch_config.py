"""The port's own config (nerf_rs_tpu_torch/config.py) held to the JAX
package's, which it copies so that the port imports nothing of the JAX
package: the same dataclasses, fields, defaults and validation, and the
same resolved config from both CLIs for every ported preset.
"""

import dataclasses

import pytest

from nerf_rs_tpu import cli as jcli
from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch import config

_CLASSES = ("CameraConfig", "ModelConfig", "RenderConfig", "ProposalConfig", "TrainConfig",
            "DataConfig", "Config")


@pytest.mark.parametrize("name", _CLASSES)
def test_dataclasses_have_the_same_fields_and_defaults(name):
    mine, theirs = getattr(config, name), getattr(jconfig, name)

    def fields(c):
        out = []
        for f in dataclasses.fields(c):
            v = f.default if f.default is not dataclasses.MISSING else f.default_factory()
            out.append((f.name, f.type, dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                        else v))
        return out

    assert fields(mine) == fields(theirs)


def test_default_config_and_compat_config_match():
    assert config.Config().to_dict() == jconfig.Config().to_dict()
    assert config.reference_compat_config().to_dict() == \
        jconfig.reference_compat_config().to_dict()
    assert config.Config().hparams() == jconfig.Config().hparams()


def test_dict_round_trip_between_packages():
    cfg = config.Config(model=config.ModelConfig(ipe=True, sigma_activation="softplus"),
                        render=config.RenderConfig(num_fine_samples=32, share_network=True,
                                                   fine_mode="standalone"))
    j = jconfig.Config.from_dict(cfg.to_dict())
    assert j.to_dict() == cfg.to_dict()
    assert config.Config.from_dict(j.to_dict()) == cfg


def test_validation_is_the_same():
    """Both packages refuse the same invalid configs with the same error."""
    bad = [dict(render=dict(sampling_space="nope")),
           dict(model=dict(ipe=True, arch="hashgrid")),
           dict(model=dict(ipe=True), camera=dict(ndc=True, near=0.0, far=1.0))]
    for kw in bad:
        errs = []
        for mod in (config, jconfig):
            with pytest.raises(ValueError) as e:
                mod.Config(**{k: getattr(mod, f"{k.capitalize()}Config")(**v)
                              for k, v in kw.items()})
            errs.append((type(e.value), str(e.value)))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("kw", [
    dict(model=dict(contract=True, compat=True)),
    dict(model=dict(contract=True), camera=dict(ndc=True, near=0.0, far=1.0)),
    dict(model=dict(contract=True), render=dict(occ_res=16)),
    dict(render=dict(sampling_space="disparity"), camera=dict(near=0.0)),
    dict(render=dict(sampling_space="disparity", compat_sampling=True)),
    dict(proposal=dict(enabled=True), render=dict(occ_res=16)),
    dict(model=dict(ipe=True), proposal=dict(enabled=True)),
], ids=["contract-compat", "contract-ndc", "contract-occ", "disparity-near0",
        "disparity-compat", "proposal-occ", "ipe-proposal"])
def test_unbounded_validation_is_the_same(kw):
    """The contraction, disparity spacing and proposal settings: both
    packages refuse the same combinations with the same error."""
    errs = []
    for mod in (config, jconfig):
        with pytest.raises(ValueError) as e:
            mod.Config(**{k: getattr(mod, f"{k.capitalize()}Config")(**v)
                          for k, v in kw.items()})
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


def _resolve(mod, argv):
    args = mod.build_parser().parse_args(argv)
    args._explicit = mod.explicit_dests(argv)
    return mod.config_from_args(args)


@pytest.mark.parametrize("argv", [
    ["train", "--dataset", "sphere"],
    ["train", "--preset", "tiny", "--dataset", "sphere"],
    ["train", "--preset", "full", "--dataset", "sphere"],
    ["train", "--preset", "hierarchical", "--dataset", "sphere"],
    ["train", "--preset", "mipnerf", "--dataset", "sphere"],
    ["train", "--preset", "hierarchical", "--dataset", "sphere", "--num_samples", "32",
     "--num_fine_samples", "64", "--white_background", "false"],
    ["train", "--preset", "mipnerf", "--dataset", "sphere", "--fine_mode", "union",
     "--sigma_activation", "relu"],
    ["render", "--preset", "mipnerf", "--dataset", "sphere", "--width", "800",
     "--height", "800"],
    ["train", "--preset", "factored", "--dataset", "sphere"],
    ["train", "--preset", "factored", "--dataset", "sphere", "--fac_levels", "3",
     "--fac_base_res", "4", "--fac_max_res", "16", "--fac_comps", "8", "--fac_aabb", "1.2",
     "--fac_l1", "1e-4", "--precision", "f32", "--sigma_activation", "relu"],
    ["eval", "--arch", "factored", "--dataset", "sphere", "--num_samples", "32"],
    ["train", "--preset", "ngp", "--dataset", "sphere"],
    ["train", "--preset", "ngp", "--dataset", "sphere", "--hash_brick", "false"],
    ["render", "--preset", "ngp", "--dataset", "sphere", "--hash_levels", "4",
     "--hash_table_log2", "10", "--hash_base_res", "4", "--hash_max_res", "32", "--hash_aabb",
     "1.2", "--precision", "f32", "--learning_rate", "1e-3"],
    ["eval", "--arch", "hashgrid", "--dataset", "sphere", "--hash_brick", "true"],
    ["train", "--preset", "unbounded", "--dataset", "sphere"],
    ["train", "--preset", "unbounded", "--dataset", "sphere", "--far", "30", "--near", "0.5",
     "--proposal_levels", "1", "--distortion_weight", "0.1"],
    ["train", "--preset", "proposal", "--dataset", "sphere"],
    ["eval", "--preset", "proposal", "--dataset", "sphere", "--proposal_samples", "32",
     "--proposal_depth", "2", "--proposal_width", "32", "--proposal_anneal_steps", "0"],
    ["render", "--dataset", "sphere", "--contract", "true", "--sampling_space", "disparity",
     "--use_proposal", "true"],
])
def test_cli_config_matches_the_jax_cli(argv):
    """Every field of the resolved config, presets and their precedence
    included."""
    mine, theirs = _resolve(cli, argv).to_dict(), _resolve(jcli, argv).to_dict()
    assert mine == theirs
