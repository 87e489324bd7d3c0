"""TF1 checkpoint name mapping for EfficientLab weights.

A copy of the JAX package's `models/tf1_import.py` (numpy and `re`). The
published FOMAML* checkpoint stores TF1 variables under scopes like

  efficientnet-b0/stem/conv2d/kernel
  efficientnet-b0/blocks_3/conv2d/kernel            (expand conv)
  efficientnet-b0/blocks_3/depthwise_conv2d/depthwise_kernel
  efficientnet-b0/blocks_3/se/conv2d/{kernel,bias}  (se_reduce)
  efficientnet-b0/blocks_3/se/conv2d_1/{kernel,bias}(se_expand)
  efficientnet-b0/blocks_3/tpu_batch_normalization{,_1,_2}/{gamma,beta,
      moving_mean,moving_variance}
  decode/decode_skip_connections_{i}/conv2d{,_1,_2,_3}/{kernel,bias}
  decode/decode_skip_connections_{i}/batch_normalization{,_1,_2,_3}/...
  decode/final_layer_weights/{kernel,bias}

(the reference's efficientnet_model.py:170-236,396-453 and
efficientlab.py:126-231). This module translates them into the flat
"params/..." / "batch_stats/..." paths of the port's checkpoints, the
paths `utils/checkpoint.params_to_jax` yields, with arrays in flax layout:
TF conv kernels are HWIO like flax, and TF depthwise kernels [kh, kw, C,
1] become [kh, kw, 1, C]. `utils/checkpoint.import_tf1_var_map` then puts
them in the port's layout ([C, 1, kh, kw] for a depthwise kernel).

Where the JAX module takes flax pytrees (`params`, `batch_stats`), this
one takes the flat dict of `params_to_jax(model)` (or any {path: array}
in that layout). The grammar covers the `rsd` model: it has no names for
ASPP or skip decoding, as the JAX module has none.

Two TF auto-numbering ambiguities make a context-free translation
impossible:
  - expand-less MBConv blocks (expand_ratio == 1, efficientnet_model.py:173)
    create neither the expand conv nor its BN, so their remaining layers'
    auto-numbers shift: plain `conv2d` is the PROJECT conv and
    `tpu_batch_normalization{,_1}` are the depthwise/project BNs;
  - RSD modules whose upsampled input width differs from the output width
    create an extra leading 1x1 projection (efficientlab.py:213-217) that
    shifts every later conv/BN number by one.
Pass `target_paths` (from flat_state_paths) and both are resolved EXACTLY
against the model that will receive the weights; without it, shape
heuristics cover the common cases.

EMA restore (efficientlab.py:407-415): variables saved as
`<name>/ExponentialMovingAverage` are skipped by default and, with
`use_ema=True`, override their base variable.

`expected_tf1_names()` derives the complete TF1 variable set of a model
from its paths via the inverse grammar, so a round trip through
`convert_tf1_vars` proves the map total. `load_tf1_checkpoint_vars`
reads an .npz conversion of the checkpoint (name -> array) produced
offline by any TF installation.
"""
import re
from typing import Dict, Optional, Set

import numpy as np

_BN_SUFFIX = {"gamma": "scale", "beta": "bias", "moving_mean": "mean",
              "moving_variance": "var"}
_BN_SUFFIX_INV = {v: k for k, v in _BN_SUFFIX.items()}
_EMA_SUFFIX = "/ExponentialMovingAverage"
_RSD_ORDER_PLAIN = ("branch_0", "branch_1", "fuse")
_RSD_ORDER_PROJ = ("upsample_proj", "branch_0", "branch_1", "fuse")


def flat_state_paths(flat: Dict[str, np.ndarray]) -> Set[str]:
    """The "params/..."/"batch_stats/..." path set of a flat state dict
    (`params_to_jax(model)`)."""
    return {k for k in flat if k.startswith(("params/", "batch_stats/"))}


def _block_has_expand(block: str, target_paths: Optional[Set[str]]
                      ) -> Optional[bool]:
    if target_paths is None:
        return None
    return "params/{}/expand_conv/kernel".format(block) in target_paths


def _rsd_has_proj(rsd: str, target_paths: Optional[Set[str]]
                  ) -> Optional[bool]:
    if target_paths is None:
        return None
    return "params/{}/upsample_proj/conv/kernel".format(rsd) in target_paths


def _map_bn(prefix_out: str, bn_name: str, suffix: str) -> Optional[str]:
    if suffix not in _BN_SUFFIX:
        return None
    collection = "params/" if suffix in ("gamma", "beta") else "batch_stats/"
    return "{}{}/{}/{}".format(collection, prefix_out, bn_name,
                               _BN_SUFFIX[suffix])


def map_tf1_name(tf_name: str,
                 backbone_scope: str = "efficientnet-b0",
                 target_paths: Optional[Set[str]] = None,
                 block_expand=None) -> Optional[str]:
    """TF1 variable name -> "params/..."/"batch_stats/..." path, or None.

    With `target_paths`, the expand-less-block and RSD-upsample-projection
    numbering shifts are resolved against the receiving pytree; without it,
    expanding blocks and projection-less RSDs are assumed.
    """
    name = tf_name.split(":")[0]
    if name.endswith(_EMA_SUFFIX):
        return None  # handled by convert_tf1_vars(use_ema=True)
    backbone_out = backbone_scope.replace("-", "_")

    # ---------------- backbone ----------------
    m = re.match(r"^{}/stem/conv2d(?:_\d+)?/kernel$".format(
        re.escape(backbone_scope)), name)
    if m:
        return "params/{}/stem_conv/kernel".format(backbone_out)
    m = re.match(r"^{}/stem/tpu_batch_normalization/(\w+)$".format(
        re.escape(backbone_scope)), name)
    if m:
        return _map_bn(backbone_out, "stem_batch_normalization", m.group(1))

    m = re.match(r"^{}/blocks_(\d+)/(.*)$".format(re.escape(backbone_scope)),
                 name)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        block = "{}/blocks_{}".format(backbone_out, idx)
        has_expand = _block_has_expand(block, target_paths)
        if has_expand is None and block_expand is not None:
            has_expand = block_expand.get(idx)
        mm = re.match(r"^conv2d(?:_(\d+))?/kernel$", rest)
        if mm:
            # Expanding block: conv2d = expand, conv2d_1 = project.
            # Expand-less block: the only conv2d is the project conv.
            if mm.group(1) is None:
                which = ("project_conv" if has_expand is False
                         else "expand_conv")
            else:
                which = "project_conv"
            return "params/{}/{}/kernel".format(block, which)
        mm = re.match(r"^depthwise_conv2d/depthwise_kernel$", rest)
        if mm:
            return "params/{}/depthwise_conv/kernel".format(block)
        mm = re.match(r"^se/conv2d(?:_(\d+))?/(kernel|bias)$", rest)
        if mm:
            which = "se_reduce" if mm.group(1) is None else "se_expand"
            return "params/{}/{}/{}".format(block, which, mm.group(2))
        mm = re.match(r"^tpu_batch_normalization(?:_(\d+))?/(\w+)$", rest)
        if mm:
            creation = 0 if mm.group(1) is None else int(mm.group(1))
            # Semantic index (0=expand BN, 1=depthwise, 2=project) equals
            # creation order only when the expand BN was created.
            semantic = creation if has_expand is not False else creation + 1
            bn_name = "batch_normalization" + ("" if semantic == 0
                                               else "_{}".format(semantic))
            return _map_bn(block, bn_name, mm.group(2))
        return None

    # ---------------- decoder ----------------
    m = re.match(r"^decode/decode_skip_connections_(\d+)/(.*)$", name)
    if m:
        rsd = "decode_skip_connections_{}".format(int(m.group(1)))
        rest = m.group(2)
        order = (_RSD_ORDER_PROJ if _rsd_has_proj(rsd, target_paths)
                 else _RSD_ORDER_PLAIN)
        mm = re.match(r"^conv2d(?:_(\d+))?/(kernel|bias)$", rest)
        if mm:
            pos = 0 if mm.group(1) is None else int(mm.group(1))
            if pos >= len(order):
                return None
            return "params/{}/{}/conv/{}".format(rsd, order[pos], mm.group(2))
        mm = re.match(r"^batch_normalization(?:_(\d+))?/(\w+)$", rest)
        if mm:
            pos = 0 if mm.group(1) is None else int(mm.group(1))
            if pos >= len(order):
                return None
            return _map_bn("{}/{}".format(rsd, order[pos]),
                           "batch_normalization", mm.group(2))
        return None

    m = re.match(r"^decode/final_layer_weights/(kernel|bias)$", name)
    if m:
        return "params/final_layer_weights/{}".format(m.group(1))
    return None


def convert_tf1_vars(tf_vars: Dict[str, np.ndarray],
                     backbone_scope: str = "efficientnet-b0",
                     rsd_has_upsample_proj: Dict[int, bool] = None,
                     target_paths: Optional[Set[str]] = None,
                     use_ema: bool = False) -> Dict[str, np.ndarray]:
    """Convert a {tf1_name: array} dict to {flax_path: array}.

    target_paths (from flat_state_paths) resolves the numbering-shift
    ambiguities exactly; otherwise `rsd_has_upsample_proj`
    ({reduction_index: bool}) plus a kernel-shape heuristic for expand-less
    blocks cover them. With use_ema, `<name>/ExponentialMovingAverage`
    values replace their base variables (efficientlab.py:407-415)."""
    rsd_has_upsample_proj = rsd_has_upsample_proj or {}
    # Without a target tree, infer which blocks have an expand conv from
    # the TF var set itself: expanding blocks own conv2d AND conv2d_1
    # (expand + project); expand-less blocks own only conv2d. This pins
    # the BN creation-order numbering exactly (blocks_0 of every variant
    # has expand_ratio=1: efficientnet builder block args).
    block_expand: Dict[int, bool] = {}
    blocks_conv = re.compile(r"^{}/blocks_(\d+)/conv2d(?:_(\d+))?/".format(
        re.escape(backbone_scope)))
    for tf_name in tf_vars:
        name = tf_name.split(":")[0]
        if name.endswith(_EMA_SUFFIX):
            name = name[:-len(_EMA_SUFFIX)]
        m = blocks_conv.match(name)
        if m:
            idx = int(m.group(1))
            block_expand.setdefault(idx, False)
            if m.group(2) is not None:
                block_expand[idx] = True
    ema = {}
    out = {}
    for tf_name, value in tf_vars.items():
        name = tf_name.split(":")[0]
        if name.endswith(_EMA_SUFFIX):
            if use_ema:
                ema[name[:-len(_EMA_SUFFIX)]] = value
            continue
        path = map_tf1_name(name, backbone_scope, target_paths,
                            block_expand=block_expand)
        if path is None:
            continue
        # Legacy RSD-projection shift when no target tree was provided.
        m = re.match(r"^decode/decode_skip_connections_(\d+)/"
                     r"(conv2d|batch_normalization)(?:_(\d+))?/", name)
        if m and target_paths is None \
                and rsd_has_upsample_proj.get(int(m.group(1)), False):
            pos = 0 if m.group(3) is None else int(m.group(3))
            if pos >= len(_RSD_ORDER_PROJ):
                continue
            rsd = "decode_skip_connections_{}".format(m.group(1))
            leaf = path.rsplit("/", 1)[1]
            collection = path.split("/", 1)[0]
            inner = ("conv" if m.group(2) == "conv2d"
                     else "batch_normalization")
            path = "{}/{}/{}/{}/{}".format(collection, rsd,
                                           _RSD_ORDER_PROJ[pos], inner, leaf)
        # Shape fallback for expand-less blocks without a target tree:
        # a 1x1 kernel mapped to expand_conv that doesn't widen channels is
        # actually the project conv.
        m = re.match(r"^params/(.*)/expand_conv/kernel$", path)
        if m and target_paths is None and value.ndim == 4 \
                and value.shape[0] == 1 and value.shape[3] <= value.shape[2]:
            path = "params/{}/project_conv/kernel".format(m.group(1))
        out[path] = (tf_name, value)

    for base, value in ema.items():
        path = map_tf1_name(base, backbone_scope, target_paths,
                            block_expand=block_expand)
        if path is not None and path in out:
            out[path] = (base + _EMA_SUFFIX, value)

    converted = {}
    for path, (src, value) in out.items():
        # TF depthwise kernels are [kh, kw, C, multiplier]; flax grouped
        # convs use [kh, kw, 1, C].
        if path.endswith("depthwise_conv/kernel") and value.ndim == 4 \
                and value.shape[3] == 1:
            value = np.transpose(value, (0, 1, 3, 2))
        converted[path] = value
    return converted


def expected_tf1_names(flat: Dict[str, np.ndarray],
                       backbone_scope: str = "efficientnet-b0"
                       ) -> Dict[str, str]:
    """{path: tf1_name} for every params/batch_stats entry of an
    EfficientLab model's flat state: the inverse grammar, derived from the
    paths themselves. Raises on a path the grammar does not cover, so a
    full-model round trip through convert_tf1_vars proves the import map
    total."""
    backbone_out = backbone_scope.replace("-", "_")
    paths = sorted(flat_state_paths(flat))
    blocks_with_expand = {
        p.split("/")[2] for p in paths
        if re.match(r"^params/{}/blocks_\d+/expand_conv/kernel$".format(
            re.escape(backbone_out)), p)}
    rsds_with_proj = {
        p.split("/")[1] for p in paths
        if re.match(r"^params/decode_skip_connections_\d+/upsample_proj/"
                    r"conv/kernel$", p)}

    def bn_tf_leaf(collection: str, leaf: str) -> str:
        return _BN_SUFFIX_INV[leaf]

    out = {}
    for path in paths:
        collection, rest = path.split("/", 1)
        parts = rest.split("/")
        tf = None
        if rest == "final_layer_weights/kernel":
            tf = "decode/final_layer_weights/kernel"
        elif rest == "final_layer_weights/bias":
            tf = "decode/final_layer_weights/bias"
        elif parts[0] == backbone_out:
            if parts[1] == "stem_conv":
                tf = "{}/stem/conv2d/kernel".format(backbone_scope)
            elif parts[1] == "stem_batch_normalization":
                tf = "{}/stem/tpu_batch_normalization/{}".format(
                    backbone_scope, bn_tf_leaf(collection, parts[2]))
            elif parts[1].startswith("blocks_"):
                block = parts[1]
                has_expand = block in blocks_with_expand
                scope = "{}/{}".format(backbone_scope, block)
                sub = parts[2]
                if sub == "expand_conv":
                    tf = "{}/conv2d/kernel".format(scope)
                elif sub == "project_conv":
                    tf = "{}/conv2d{}/kernel".format(
                        scope, "_1" if has_expand else "")
                elif sub == "depthwise_conv":
                    tf = "{}/depthwise_conv2d/depthwise_kernel".format(scope)
                elif sub == "se_reduce":
                    tf = "{}/se/conv2d/{}".format(scope, parts[3])
                elif sub == "se_expand":
                    tf = "{}/se/conv2d_1/{}".format(scope, parts[3])
                elif sub.startswith("batch_normalization"):
                    semantic = (0 if sub == "batch_normalization"
                                else int(sub.rsplit("_", 1)[1]))
                    creation = semantic if has_expand else semantic - 1
                    tf = "{}/tpu_batch_normalization{}/{}".format(
                        scope, "" if creation == 0 else "_%d" % creation,
                        bn_tf_leaf(collection, parts[3]))
        elif parts[0].startswith("decode_skip_connections_"):
            rsd = parts[0]
            order = (_RSD_ORDER_PROJ if rsd in rsds_with_proj
                     else _RSD_ORDER_PLAIN)
            pos = order.index(parts[1])
            scope = "decode/{}".format(rsd)
            if parts[2] == "conv":
                tf = "{}/conv2d{}/{}".format(
                    scope, "" if pos == 0 else "_%d" % pos, parts[3])
            elif parts[2] == "batch_normalization":
                tf = "{}/batch_normalization{}/{}".format(
                    scope, "" if pos == 0 else "_%d" % pos,
                    bn_tf_leaf(collection, parts[3]))
        if tf is None:
            raise ValueError(
                "no TF1 grammar rule covers pytree leaf: " + path)
        out[path] = tf
    return out


def assert_complete_import(converted: Dict[str, np.ndarray],
                           flat: Dict[str, np.ndarray]) -> None:
    """Raise unless `converted` covers every params/batch_stats entry of
    the flat state `flat` with matching (flax-layout) shapes."""
    flat = {k: v for k, v in flat.items()
            if k.startswith(("params/", "batch_stats/"))}
    missing = sorted(set(flat) - set(converted))
    if missing:
        raise ValueError("import misses {} leaves, e.g. {}".format(
            len(missing), missing[:5]))
    extra = sorted(set(converted) - set(flat))
    if extra:
        raise ValueError("import produced {} unknown paths, e.g. {}".format(
            len(extra), extra[:5]))
    for path, value in converted.items():
        want = tuple(np.shape(flat[path]))
        got = tuple(np.shape(value))
        if want != got:
            raise ValueError("shape mismatch at {}: checkpoint {} vs model "
                             "{}".format(path, got, want))


def load_tf1_checkpoint_vars(npz_path: str) -> Dict[str, np.ndarray]:
    """Load an offline-converted {tf_name: array} npz."""
    with np.load(npz_path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
