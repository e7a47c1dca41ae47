"""Checkpoints: per-network state_dicts with their architecture config, and
the full train state (port of ``cat_tpu/utils/checkpoint.py``).

A network is ``<save_dir>/<tag>_net_<name>.pth``, a ``state_dict`` in the
reference CAT key layout, beside ``<tag>_net_<name>.json``, its config as
``core/config.py::config_to_json`` writes it.  The full train state is
``<tag>_state.pth`` and run metadata ``<tag>_meta.json``.  Tags and file
names follow the JAX package ({epoch|latest|best|iterN}_net_{G,G_raw,D,A});
writes are atomic, so ``copy_tag`` may hard-link one tag's files to another.

The JAX package writes ``.msgpack`` files (flax's serialisation): a tree of
dicts whose arrays are msgpack extension type 1 holding the msgpack of
(shape, dtype name, C-order bytes).  ``read_msgpack`` decodes that layout
with the ``msgpack`` package alone; ``utils/jax_import.py`` maps the tree to
the port's state_dicts.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cat_tpu_torch.core.config import config_from_json, config_to_json


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """``torch.save`` a nested dict of tensors (moved to the host) and plain
    values; atomic: the file is replaced, never truncated in place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, path)


def load_pytree(path: str) -> Any:
    """A ``.pth`` file of this package, or a ``.msgpack`` file of the JAX
    package (then a tree of numpy arrays)."""
    if path.endswith(".msgpack"):
        return read_msgpack(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _write_text(path: str, text: str) -> None:
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def save_net(save_dir: str, tag: str, net_name: str, state_dict: Dict[str, torch.Tensor],
             config: Any = None) -> str:
    """Save one network: <save_dir>/<tag>_net_<name>.pth (+ .json config)."""
    path = os.path.join(save_dir, f"{tag}_net_{net_name}.pth")
    save_pytree(path, state_dict)
    if config is not None:
        _write_text(path[: -len(".pth")] + ".json", config_to_json(config))
    return path


def read_config(path: str) -> Optional[Any]:
    """The config sidecar of a checkpoint file (``.json`` beside it), or
    None."""
    cfg_path = os.path.splitext(path)[0] + ".json"
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        return config_from_json(f.read())


def load_net(save_dir: str, tag: str, net_name: str) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(state_dict, config-or-None)."""
    path = os.path.join(save_dir, f"{tag}_net_{net_name}.pth")
    return load_pytree(path), read_config(path)


def save_train_state(save_dir: str, tag: str, state: Dict) -> str:
    """Full train state (parameters, optimiser moments, step, RNG)."""
    path = os.path.join(save_dir, f"{tag}_state.pth")
    save_pytree(path, state)
    return path


def load_train_state(save_dir: str, tag: str) -> Dict:
    return load_pytree(os.path.join(save_dir, f"{tag}_state.pth"))


def copy_tag(save_dir: str, src_tag: str, dst_tag: str) -> int:
    """Duplicate every ``<src_tag>_*`` checkpoint file as ``<dst_tag>_*``
    (hard links where the file system allows), so a state saved under several
    tags is serialised once.  A ``<dst_tag>`` file with no source
    counterpart is a leftover of an earlier run and is removed.  Returns the
    number of files copied."""

    def tag_files(tag):
        # only the suffixes checkpointing writes: a bare `<tag>_*` glob
        # would make tag 'best' match 'best_A_net_G.pth'
        out = []
        for pat in (f"{tag}_net_*", f"{tag}_state.pth", f"{tag}_meta.json"):
            out.extend(glob.glob(os.path.join(save_dir, pat)))
        return [p for p in out if not p.endswith(".tmp")]

    srcs = tag_files(src_tag)
    suffixes = {os.path.basename(p)[len(src_tag) + 1:] for p in srcs}
    for dst in tag_files(dst_tag):
        if os.path.basename(dst)[len(dst_tag) + 1:] not in suffixes:
            os.remove(dst)
    for src in srcs:
        dst = os.path.join(save_dir, f"{dst_tag}_{os.path.basename(src)[len(src_tag) + 1:]}")
        if os.path.exists(dst):
            os.remove(dst)
        try:
            os.link(src, dst)
        except OSError:
            shutil.copyfile(src, dst)
    return len(srcs)


def remove_stale(save_dir: str, tag: str, suffix: str) -> None:
    """Remove ``<tag>_<suffix>`` left by an earlier run whose options wrote
    it, so tag copies never pair this run's nets with another run's."""
    path = os.path.join(save_dir, f"{tag}_{suffix}")
    if os.path.exists(path):
        os.remove(path)


def save_meta(save_dir: str, tag: str, meta: Dict) -> None:
    os.makedirs(save_dir, exist_ok=True)
    _write_text(os.path.join(save_dir, f"{tag}_meta.json"), json.dumps(meta, indent=2))


def load_meta(save_dir: str, tag: str) -> Dict:
    with open(os.path.join(save_dir, f"{tag}_meta.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# The JAX package's .msgpack files
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: widen the bits
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def read_msgpack(path: str) -> Any:
    """The tree of a flax ``.msgpack`` file: dicts of numpy arrays (lists and
    dataclasses appear as dicts, as flax stores them)."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs the 'msgpack' package (the JAX package's "
            "checkpoint format), which is not installed"
        ) from e

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _ndarray(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _ndarray(msgpack, data)[()]
        raise ValueError(f"{path}: msgpack extension type {code} is not an array")

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
