"""The reference's op-string architecture DSL (counterpart of
contrastboundary_tpu/config/dsl.py: the same grammar, token for token).

Strings like 'pospool|multi-Ua-concat-latent|contrast-Ua-softnn-latent-
label-l2-w.1' select the backbone and the heads; stage specs like 'Ua' or
'D012_U34' select stages. The port parses every string the JAX package
parses, and raises where the JAX package raises (ValueError for an unknown
token, NotImplementedError for the sample sources it does not wire). Every
contrast segment parses to the port's ContrastConfig (losses/contrast.py),
equal to the JAX package's on every field. A MultiHead option that the
port's model does not have (any but the flagship's and ``sep``) raises
NotImplementedError naming the ROADMAP Queue A item that ports it; an
option left at the reference's default is not one. The flagship's
'multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1' parses to
the port's ``ContrastConfig()`` and the flagship MultiHead; the plain
head's 'mlp-<depth>-<loss>...' to the JAX package's dict.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

from ..losses.contrast import ContrastConfig

# ROADMAP Queue A item of the options the port's heads lack
OPTIONS_ITEM = "ROADMAP Queue A item 7"


def parse_stage(spec: str, num_layers: int) -> List[Tuple[str, int]]:
    """'Ua' → all up stages; 'U0' → [(up,0)]; 'D012_U34' → down 0,1,2 + up 3,4;
    'a' alone → all up stages."""
    spec = spec or "Ua"
    out: List[Tuple[str, int]] = []
    for part in spec.split("_"):
        if not part:
            continue
        m = re.match(r"^([UDud]?)([0-9a]+)$", part)
        if not m:
            raise ValueError(f"invalid stage spec {part!r} in {spec!r}")
        side = {"U": "up", "D": "down", "": "up"}[m.group(1).upper()]
        digits = m.group(2)
        if digits == "a":
            out += [(side, i) for i in range(num_layers)]
        else:
            out += [(side, int(d)) for d in digits]
    return out


_WEIGHT_RE = re.compile(r"^w(\d*\.?\d+)$")
# temperature: 'T1' or the reference's margin/temperature token 'mT.5'/'mT2'
_TEMP_RE = re.compile(r"^m?T(\d*\.?\d+)$")
_LABELKL_RE = re.compile(r"^labelkl(\d*\.?\d+)?$")
# margin token 'm<x>' (not 'mask'/'max'): inside the value 'T<f>' sets the
# temperature and 'S' the separate-pos term
_MARGIN_RE = re.compile(r"^m(?!ask$)(?!ax$)(\S+)$")
_MASK_RE = re.compile(r"^mask(\d*\.?\d+|\.\d+)?$")
_POWER_RE = re.compile(r"^p(\d*\.?\d+)$")


def _unported(what: str, key: str, value) -> NotImplementedError:
    return NotImplementedError(f"{what} option {key}={value!r} is not ported ({OPTIONS_ITEM})")


def parse_contrast_ops(ops: str, num_layers: int = 5) -> ContrastConfig:
    """Parse 'contrast-Ua-softnn-latent-label-l2-w.1' (order-insensitive
    tokens) into the port's ContrastConfig."""
    tokens = ops.split("-")
    if tokens and tokens[0] == "contrast":
        tokens = tokens[1:]

    kw = dict(contrast="softnn", dist="l2", pos="cnt", temperature=1.0, weight=0.1)
    stages: Optional[Tuple[int, ...]] = None
    for t in tokens:
        if not t:
            continue
        if t in ("softnn", "nce"):
            kw["contrast"] = t
        elif t in ("l2", "l2square", "norml2", "kl", "cos"):
            kw["dist"] = "norml2" if t == "cos" else t
        elif t in ("latent", "logits", "probs", "f_out", "fout"):
            kw["ftype"] = "f_out" if t == "fout" else t
        elif t in ("label", "cnt"):
            pass  # sample source; 'label' is the flagship default
        elif t in ("glb", "sub", "subspatial", "pts", "vote"):
            raise NotImplementedError(
                f"contrast sample source {t!r} is not wired — only "
                f"label-neighborhood sampling (+nn<k>/rand<k>) is implemented"
            )
        elif _LABELKL_RE.match(t):
            m = _LABELKL_RE.match(t)
            kw["pos"] = "kl"
            if m.group(1):
                kw["kl_threshold"] = float(m.group(1))
        elif _WEIGHT_RE.match(t):
            kw["weight"] = float(_WEIGHT_RE.match(t).group(1))
        elif t.startswith("w."):
            kw["weight"] = float(t[1:])
        elif _TEMP_RE.match(t):
            kw["temperature"] = float(_TEMP_RE.match(t).group(1))
        elif _MASK_RE.match(t):
            kw["mask_mode"] = True
        elif _MARGIN_RE.match(t):
            val = _MARGIN_RE.match(t).group(1)
            kw["margin"] = val
            if "T" in val:
                kw["temperature"] = float(val[val.index("T") + 1:])
            if "S" in val:
                kw["separate_pos"] = True
        elif _POWER_RE.match(t):
            kw["power"] = float(_POWER_RE.match(t).group(1))
        elif t.startswith("proj"):
            kw["project"] = t[4:] or "mlp"
        elif t in ("nst", "max", "soft", "recur", "recurhard"):
            kw["label_infer"] = t
        elif t.startswith("label_") and t[6:] in ("nst", "recur", "recurhard"):
            kw["label_infer"] = t[6:]
        elif re.match(r"^nn\d+$", t):
            kw["extra_pos_nn"] = int(t[2:])
        elif re.match(r"^rand\d+$", t):
            kw["extra_neg_rand"] = int(t[4:])
        elif re.match(r"^[UDud]?[0-9a]+$", t):
            stages = tuple(i for _, i in parse_stage(t, num_layers))
        else:
            raise ValueError(f"unknown contrast token {t!r} in {ops!r}")
    kw["stages"] = stages if stages is not None else tuple(range(num_layers))
    return ContrastConfig(**kw)


_DROP_RE = re.compile(r"^dp(\d*\.?\d+|\.\d+)$")


def parse_mlp_ops(ops: str) -> dict:
    """Parse the plain-head op-string '<depth>-<loss>[-dp<p>][-w<f>]' as the
    reference does → {'depth', 'loss', 'drop', 'weight', 'class_weight'}:
    the depth of the latent tower, the loss xen | sigmoid | none, dropout
    on the latent, a float loss weight and 'class' (inverse-frequency class
    weights from the train split, losses/segmentation.py::
    inverse_frequency_weights); 'center' raises, 'pred' is ignored."""
    tokens = ops.split("-")
    if tokens and tokens[0] == "mlp":
        tokens = tokens[1:]
    out = {"depth": 1, "loss": "xen", "drop": None, "weight": 1.0, "class_weight": False}
    for t in tokens:
        if not t:
            continue
        if t.isdigit():
            out["depth"] = int(t)
        elif t in ("xen", "sigmoid", "none"):
            out["loss"] = t
        elif _DROP_RE.match(t):
            out["drop"] = float(_DROP_RE.match(t).group(1))
        elif _WEIGHT_RE.match(t):
            out["weight"] = float(_WEIGHT_RE.match(t).group(1))
        elif t == "class":
            out["class_weight"] = True
        elif t == "center":
            raise NotImplementedError(
                "mlp-head weight 'center': dead grammar — the reference "
                "dispatches to get_class_weight (tensorflow/models/heads/"
                "head.py:326) which is undefined in the reference codebase"
            )
        elif t == "pred":
            pass
        else:
            raise ValueError(f"unknown mlp-head token {t!r} in {ops!r}")
    return out


_BRANCH_LOSS_RE = re.compile(r"^(loss(?:Sub)?)((?:\d*\.)?\d+)?$")
_CONDITION_RE = re.compile(r"^(concat|sum|max)(\d+|A)$")


def flagship_multi(num_layers: int = 5) -> dict:
    """The MultiHead options the port's model has: a latent tower on every
    up stage, concatenated ('multi-Ua-concat-latent'), and ``sep``."""
    return {"stages": tuple(range(num_layers)), "combine": "concat", "ftype": "latent",
            "branch_loss": "", "branch_weight": 1.0, "condition": "", "sep_head": False}


def parse_multi_ops(ops: str, num_layers: int = 5) -> dict:
    """Parse 'multi-Ua-concat-latent' → {'stages', 'combine', 'ftype',
    'branch_loss', 'branch_weight', 'condition', 'sep_head'}, the JAX
    package's dict. ``sep`` (the contrast branch's own towers) is taken;
    any other value than the flagship's (flagship_multi; the branch weight
    counts only with a branch loss) raises NotImplementedError: the port's
    MultiHead has no other."""
    tokens = ops.split("-")
    if tokens and tokens[0] == "multi":
        tokens = tokens[1:]
    out = flagship_multi(num_layers)
    for t in tokens:
        if not t:
            continue
        if t in ("concat", "concatmlp", "sum"):
            out["combine"] = t
        elif t == "sep":
            out["sep_head"] = True
        elif t in ("latent", "logits", "probs", "f_out", "fout"):
            out["ftype"] = "f_out" if t == "fout" else t
        elif _BRANCH_LOSS_RE.match(t):
            m = _BRANCH_LOSS_RE.match(t)
            out["branch_loss"] = m.group(1)
            if m.group(2):
                out["branch_weight"] = float(m.group(2))
        elif _CONDITION_RE.match(t):
            out["condition"] = t
        elif re.match(r"^[UDud]?[0-9a]+$", t):
            out["stages"] = tuple(i for _, i in parse_stage(t, num_layers))
        else:
            raise ValueError(f"unknown multi token {t!r} in {ops!r}")
    flagship = flagship_multi(num_layers)
    for key, value in out.items():
        if key == "sep_head" or (key == "branch_weight" and not out["branch_loss"]):
            continue
        if value != flagship[key]:
            raise _unported("multi head", key, value)
    return out


def parse_arch_out(arch_out: str, num_layers: int = 5) -> dict:
    """Split a full head spec 'multi-...|contrast-...' into parsed heads
    ({'multi': dict, 'contrast': ContrastConfig, 'backbone': str}; a
    leading segment that is no head names the backbone)."""
    heads: dict = {}
    for pos, seg in enumerate(arch_out.split("|")):
        seg = seg.strip()
        if not seg:
            continue
        if seg.startswith("multi"):
            heads["multi"] = parse_multi_ops(seg, num_layers)
        elif seg.startswith("contrast"):
            heads["contrast"] = parse_contrast_ops(seg, num_layers)
        elif seg.startswith("mlp") or re.match(r"^\d+-", seg):
            heads["mlp"] = parse_mlp_ops(seg)
        elif pos == 0:
            heads["backbone"] = seg
        else:
            raise ValueError(f"unknown head segment {seg!r}")
    return heads
