"""Config: argparse + YAML with the schema of ``instancerefer_tpu/config.py``.

The card's machine has no PyYAML, so ``read_yaml`` reads the subset of YAML
the repo's configs use, and raises on anything else rather than guess:

* top-level section headers (``TRAIN:``), each followed by ``key: value``
  lines at one indentation;
* ints, floats with a decimal point (``0.00001``), ``True``/``False``,
  ``null``/``~`` or an empty value (None), plain words, paths and run
  stamps (``2026-01-01_00-00-00_NAME``);
* flow lists of those (``[15, 20]``);
* ``#`` comments on their own line or after a value.

``Config`` holds every field of the JAX package's ``Config`` that the port
consumes, with the same defaults, plus ``device``.  The TPU band geometry
(the ``pallas_*`` keys other than ``pallas_conv``) has no meaning here, and
four keys change nothing, in JAX either: those keys are named in
``IGNORED_KEYS`` and skipped.  ``pallas_conv`` keeps one meaning, the raster
row order of the host pipeline's voxels (the port gathers exactly and builds
no bands of its own).  ``lang_bucket`` sets each batch's
token grid; the packed GRU gives the same result on any grid.
``compute_dtype`` is the sparse convs' input type (``ops/precision``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import warnings
from typing import Any, Dict, List, Optional, Sequence

import torch

from instancerefer_tpu_torch.data.host import BatchSpec

# JAX Config fields the port does not keep: keys that change nothing, in JAX
# either (its solver stores val_step but validates once an epoch; --debug is
# parsed and dropped), and the banded Pallas conv geometry
IGNORED_KEYS = (
    "model", "language_module", "val_step", "debug",
    "pallas_chunk", "pallas_window", "pallas_subwin", "pallas_subwin_inst",
    "pallas_count_drops", "pallas_down_chunk", "pallas_down_subwin",
    "pallas_down_window", "pallas_down_subwin_inst", "pallas_down_window_inst",
    "pallas_up_window", "pallas_up_subwin",
)


@dataclasses.dataclass
class Config:
    # GENERAL
    manual_seed: int = 123
    # DATA (config/InstanceRefer.yaml:4-15)
    dataset: str = "ScanRefer"
    num_points: int = 40000
    num_scenes: int = -1
    num_classes: int = 18
    use_augment: bool = True
    use_height: bool = True
    use_color: bool = True
    use_normal: bool = False
    use_multiview: bool = False
    # MODEL (:17-41)
    use_gt_lang: bool = True
    attribute_module: str = "attribute_module"
    voxel_size_ap: float = 0.02
    relation_module: str = "relation_module"
    k: int = 8
    scene_module: str = "scene_module"
    voxel_size_glp: float = 0.05
    use_bidir: bool = True
    use_checkpoint: Optional[str] = None
    use_pretrained: Any = False
    # TRAIN (:43-57)
    batch_size: int = 64
    num_workers: int = 4
    epoch: int = 25
    lr: float = 0.001
    lr_decay_step: Sequence[int] = (15, 20)
    lr_decay_rate: float = 0.1
    bn_decay_step: Optional[int] = None
    bn_decay_rate: Optional[float] = None
    wd: float = 0.00001
    verbose: int = 20
    start_val: int = 0
    # CLI
    gpu: str = "0"  # index of the card when device is cuda
    config: str = "config/InstanceRefer.yaml"
    log_dir: str = "test"
    pretrain: str = ""
    device: str = "cuda"
    # constants (lib/config.py:73-75)
    max_des_len: int = 126
    seed: int = 42
    # padded capacities of the host pipeline
    max_instances: int = 128
    max_candidates: int = 16
    scene_caps: Sequence[int] = (20480, 8192, 4096, 2048, 1024)
    inst_caps: Sequence[int] = (4096, 2048, 1024, 512, 256)
    compute_dtype: str = "bfloat16"
    pallas_conv: bool = True
    lang_bucket: int = 32
    # a calibration profile whose capacity keys (and pallas_conv) overlay
    # the ones above at load time
    band_profile: Optional[str] = None
    # eval fails on any capacity overflow unless this is set
    allow_overflow: bool = False
    data_root: str = "data"
    output_root: str = "outputs"

    @property
    def input_feature_dim(self) -> int:
        """Channel arithmetic of the reference's scripts/train.py:74-75."""
        return (
            int(self.use_multiview) * 128
            + int(self.use_normal) * 3
            + int(self.use_color) * 3
            + int(self.use_height + 3)
        )

    def batch_spec(self) -> BatchSpec:
        """The host pipeline's spec: the JAX package's, with ``pallas_conv``
        as written (it selects the raster order; nothing here asks which
        backend runs) and one data shard."""
        return BatchSpec(
            max_tokens=self.max_des_len,
            max_instances=self.max_instances,
            max_candidates=self.max_candidates,
            scene_caps=tuple(self.scene_caps),
            inst_caps=tuple(self.inst_caps),
            num_classes=self.num_classes,
            feat_dim=self.input_feature_dim,
            pallas_conv=bool(self.pallas_conv),
            lang_bucket=self.lang_bucket,
            data_shards=1,
        )

    def torch_device(self) -> torch.device:
        """``device``: ``cuda`` (card ``gpu``) or ``cpu``.  ``cuda`` without a
        card raises: nothing runs on the CPU unless asked to."""
        if self.device == "cpu":
            return torch.device("cpu")
        if self.device != "cuda":
            raise ValueError(f"device {self.device!r} is neither cuda nor cpu")
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        return torch.device("cuda", int(self.gpu))

    # ---- reference path tree (lib/config.py:34-70)
    @property
    def path_scannet(self):
        return os.path.join(self.data_root, "scannet")

    @property
    def path_scannet_meta(self):
        return os.path.join(self.path_scannet, "meta_data")

    @property
    def exp_path(self):
        return os.path.join(self.output_root, self.dataset, self.log_dir)

    @property
    def path_output(self):
        return os.path.join(self.exp_path, "checkpoints")


# ------------------------------------------------------------------ YAML subset
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?: +(.*))?$")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?$")
_WORD = re.compile(r"(?:[A-Za-z_]|\.{1,2}/|/)[A-Za-z0-9_./-]*$")
# a run directory's stamp (scripts/train.py); the "_" after the day keeps it
# from being a YAML date
_STAMP = re.compile(r"[0-9]{4}-[0-9]{2}-[0-9]{2}_[A-Za-z0-9_.-]*$")
_NULL = ("", "~", "null", "Null", "NULL")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
# YAML 1.1 reads these as booleans too; a config should not lean on that
_AMBIGUOUS = {"yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off", "Off", "OFF"}


def _scalar(text: str, where: str):
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if (text not in _AMBIGUOUS and _WORD.match(text)) or _STAMP.match(text):
        return text
    raise ValueError(f"{where}: unsupported YAML value {text!r}")


def _value(text: str, where: str):
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: unsupported YAML value {text!r}")
        inner = text[1:-1].strip()
        if not inner:
            return []
        items = [t.strip() for t in inner.split(",")]
        if any(not t for t in items):
            raise ValueError(f"{where}: empty item in {text!r}")
        return [_scalar(t, where) for t in items]
    return _scalar(text, where)


def _strip_comment(line: str) -> str:
    for i, ch in enumerate(line):
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str, name: str = "<yaml>") -> Dict[str, Optional[Dict[str, Any]]]:
    """{section: {key: value} or None} of the YAML subset; equals
    ``yaml.safe_load`` wherever it returns."""
    data: Dict[str, Optional[Dict[str, Any]]] = {}
    section, indent = None, None
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        if "\t" in raw:
            raise ValueError(f"{where}: tab in YAML")
        line = _strip_comment(raw).rstrip()
        if not line:
            continue
        body = line.lstrip(" ")
        m = _KEY.match(body)
        if not m:
            raise ValueError(f"{where}: unsupported YAML line {raw!r}")
        key, value = m.group(1), m.group(2)
        depth = len(line) - len(body)
        if depth == 0:
            if value is not None:
                raise ValueError(f"{where}: a top-level key must open a section")
            if key in data:
                raise ValueError(f"{where}: section {key} repeated")
            data[key], section, indent = None, key, None
            continue
        if section is None or (indent is not None and depth != indent):
            raise ValueError(f"{where}: unexpected indentation")
        indent = depth
        entries = data[section] if data[section] is not None else {}
        if key in entries:
            raise ValueError(f"{where}: key {key} repeated")
        entries[key] = None if value is None else _value(value.strip(), where)
        data[section] = entries
    return data


def read_yaml(path: str) -> Dict[str, Optional[Dict[str, Any]]]:
    with open(path) as f:
        return parse_yaml(f.read(), path)


def flatten_yaml(path: str) -> Dict[str, Any]:
    """The sections' keys on one namespace (lib/config.py:24-26)."""
    flat: Dict[str, Any] = {}
    for entries in read_yaml(path).values():
        flat.update(entries or {})
    return flat


_PROFILE_CAP_KEYS = ("scene_caps", "inst_caps", "max_candidates", "max_instances")


def band_profile_kwargs(path: str) -> Dict[str, Any]:
    """The keys of a calibration profile that the port applies: the fitted
    capacities and ``pallas_conv``; lists become tuples.  The JAX package
    also applies the profile's band geometry, which the port ignores."""
    return {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in flatten_yaml(path).items()
        if (k in _PROFILE_CAP_KEYS or k == "pallas_conv") and v is not None
    }


def load_config(argv: Optional[List[str]] = None) -> Config:
    """CLI flags (those of the JAX package, and ``--device``) + YAML -> Config."""
    parser = argparse.ArgumentParser(description="InstanceRefer (PyTorch)")
    parser.add_argument("--gpu", type=str, default="0", help="index of the card")
    parser.add_argument("--config", type=str, default="config/InstanceRefer.yaml")
    parser.add_argument("--log_dir", type=str, default="test")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--pretrain", type=str, default="")
    parser.add_argument("--data_root", type=str, default="data")
    parser.add_argument("--output_root", type=str, default="outputs")
    parser.add_argument(
        "--allow_overflow", action="store_true",
        help="downgrade the eval-time capacity-overflow failure to a warning",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (the default) needs a card; cpu must be asked for")
    args = parser.parse_args(argv)

    cfg = Config()
    known = {f.name for f in dataclasses.fields(Config)}
    explicit = set()
    if args.config and os.path.exists(args.config):
        for k, v in flatten_yaml(args.config).items():
            if k in known and v is not None:
                setattr(cfg, k, v)
                explicit.add(k)
    if cfg.band_profile:
        # relative paths resolve against the main config's directory, then the cwd
        prof = cfg.band_profile
        if not os.path.exists(prof) and args.config:
            cand = os.path.join(os.path.dirname(os.path.abspath(args.config)), prof)
            prof = cand if os.path.exists(cand) else prof
        if not os.path.exists(prof):
            raise FileNotFoundError(f"band_profile {cfg.band_profile!r} not found")
        overridden = []
        for k, v in band_profile_kwargs(prof).items():
            if k in explicit and getattr(cfg, k) != v:
                overridden.append(k)
            setattr(cfg, k, v)
        if overridden:
            warnings.warn(
                f"band_profile {prof!r} overrides values the main config set "
                f"explicitly: {sorted(overridden)}",
                stacklevel=2,
            )
    for k in ["gpu", "config", "log_dir", "pretrain", "data_root", "output_root", "device"]:
        setattr(cfg, k, getattr(args, k))
    if args.allow_overflow:
        cfg.allow_overflow = True
    return cfg
