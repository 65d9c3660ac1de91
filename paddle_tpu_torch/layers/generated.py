"""Table-generated layer functions over the registered ops (port of the
rows of ``paddle_tpu/layers/generated.py`` whose op types the port
registers), with the reference's aliases and hand compositions over
those ops.

A generated function maps its positional args to the op's input slots
and its keyword args to attrs, creates every output slot and returns
the primary one, as the reference's ``generate_layer_fn`` does."""

from __future__ import annotations

from ..core import unique_name
from ..core.ir import default_main_program
from ..layer_helper import LayerHelper

__all__ = []


def _register(name, fn):
    fn.__name__ = name
    globals()[name] = fn
    __all__.append(name)
    return fn


def generate_layer_fn(op_type, in_slots, out_slots, primary=None, doc=""):
    """A layer function for ``op_type``: positional args map to
    ``in_slots`` (None skips a slot), keyword args become attrs; returns
    the primary output var."""
    primary = primary or out_slots[0]

    def fn(*args, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        if len(args) > len(in_slots):
            raise TypeError(f"{op_type}() takes at most {len(in_slots)} "
                            f"positional args ({in_slots})")
        dtype = None
        inputs = {}
        for slot, arg in zip(in_slots, args):
            if arg is None:
                continue
            inputs[slot] = list(arg) if isinstance(arg, (list, tuple)) \
                else [arg]
            if dtype is None:
                dtype = getattr(inputs[slot][0], "dtype", None)
        outs = {s: [helper.create_variable_for_type_inference(
            attrs.get("dtype", dtype or "float32"))] for s in out_slots}
        helper.append_op(op_type, inputs, outs, attrs)
        return outs[primary][0]

    fn.__doc__ = doc or (f"Generated wrapper over the `{op_type}` op "
                         f"(inputs {in_slots} -> {primary}).")
    return fn


# (name, op_type, input slots, output slots[, primary]): the reference's
# rows whose op types the port registers
TABLE = [
    ("brelu", "brelu", ["X"], ["Out"]),
    ("hard_shrink", "hard_shrink", ["X"], ["Out"]),
    ("hard_sigmoid", "hard_sigmoid", ["X"], ["Out"]),
    ("hard_swish", "hard_swish", ["X"], ["Out"]),
    ("logical_not", "logical_not", ["X"], ["Out"]),
    ("isfinite", "isfinite", ["X"], ["Out"]),
    ("reduce_all", "reduce_all", ["X"], ["Out"]),
    ("reduce_any", "reduce_any", ["X"], ["Out"]),
    ("logical_and", "logical_and", ["X", "Y"], ["Out"]),
    ("logical_or", "logical_or", ["X", "Y"], ["Out"]),
    ("logical_xor", "logical_xor", ["X", "Y"], ["Out"]),
    ("less_equal", "less_equal", ["X", "Y"], ["Out"]),
    ("greater_equal", "greater_equal", ["X", "Y"], ["Out"]),
    ("elementwise_floordiv", "elementwise_floordiv", ["X", "Y"], ["Out"]),
    ("gather_nd", "gather_nd", ["X", "Index"], ["Out"]),
    ("scatter", "scatter", ["X", "Ids", "Updates"], ["Out"]),
    ("gather_tree", "gather_tree", ["Ids", "Parents"], ["Out"]),
    ("shape", "shape", ["Input"], ["Out"]),
    ("strided_slice", "strided_slice", ["Input"], ["Out"]),
    ("uniform_random", "uniform_random", [], ["Out"]),
    ("gaussian_random", "gaussian_random", [], ["Out"]),
    ("fill_constant_batch_size_like", "fill_constant_batch_size_like",
     ["Input"], ["Out"]),
    ("pad2d", "pad2d", ["X"], ["Out"]),
    ("lrn", "lrn", ["X"], ["Out", "MidOut"], "Out"),
    ("margin_rank_loss", "margin_rank_loss", ["Label", "X1", "X2"],
     ["Out", "Activated"], "Out"),
    ("huber_loss", "huber_loss", ["X", "Y"], ["Out", "Residual"], "Out"),
    ("kldiv_loss", "kldiv_loss", ["X", "Target"], ["Loss"]),
    ("lstm", "lstm",
     ["Input", "WeightX", "WeightH", "Bias", "H0", "C0", "SequenceLength"],
     ["Out", "LastH", "LastC"], "Out"),
    ("gru_unit", "gru_unit", ["Input", "HiddenPrev", "Weight", "Bias"],
     ["Hidden", "ResetHiddenPrev", "Gate"], "Hidden"),
    ("lstm_unit", "lstm_unit", ["X", "C_prev"], ["H", "C"], "H"),
    ("warpctc", "warpctc", ["Logits", "Label", "LogitsLength", "LabelLength"],
     ["Loss", "WarpCTCGrad"], "Loss"),
    ("bilinear_tensor_product", "bilinear_tensor_product",
     ["X", "Y", "Weight", "Bias"], ["Out"]),
    ("beam_search", "beam_search", ["pre_ids", "pre_scores", "scores"],
     ["selected_ids", "selected_scores", "parent_idx"], "selected_ids"),
    ("beam_search_decode", "beam_search_decode",
     ["Ids", "Scores", "ParentIdx"],
     ["SentenceIds", "SentenceScores"], "SentenceIds"),
    ("array_read", "array_read", ["X", "I"], ["Out"]),
    ("sequence_concat", "sequence_concat", ["X", "Lod"],
     ["Out", "OutLod"], "Out"),
    ("sequence_conv", "sequence_conv", ["X", "Filter"], ["Out"]),
    ("sequence_enumerate", "sequence_enumerate", ["X"], ["Out"]),
    ("sequence_expand", "sequence_expand", ["X", "RefLod"], ["Out"]),
    ("sequence_expand_as", "sequence_expand_as", ["X", "Y", "YLength"],
     ["Out", "OutLength"], "Out"),
    ("sequence_pad", "sequence_pad", ["X", "Lod", "PadValue"],
     ["Out", "Length"], "Out"),
    ("sequence_reshape", "sequence_reshape", ["X"], ["Out"]),
    ("sequence_reverse", "sequence_reverse", ["X", "Lod"], ["Y"]),
    ("sequence_scatter", "sequence_scatter", ["X", "Ids", "Updates"],
     ["Out"]),
    ("sequence_slice", "sequence_slice", ["X", "Offset", "Length"],
     ["Out", "OutLength"], "Out"),
    ("sequence_softmax", "sequence_softmax", ["X", "Lod"], ["Out"]),
    ("sequence_unpad", "sequence_unpad", ["X", "Length"], ["Out"]),
]

for _row in TABLE:
    _register(_row[0], generate_layer_fn(_row[1], _row[2], _row[3],
                                         _row[4] if len(_row) > 4 else None))


def _aw(x, i, array, name=None):
    """array_write: the stacked array with slot ``i`` set to ``x``."""
    helper = LayerHelper("array_write", name=name)
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op("array_write", {"X": [array], "I": [i], "V": [x]},
                     {"Out": [out]}, {})
    return out


_register("array_write", _aw)


# --- the reference's aliases from its paddle.tensor / nn.functional -----

def _static_op(op_type, ins, attrs, out_slot="Out"):
    """One op with one output var named after the op and slot, as the
    reference's functional ``_op`` appends it in a static program."""
    block = default_main_program().current_block()
    out = block.create_var(name=unique_name.generate(
        f"{op_type}.{out_slot.lower()}"))
    block.append_op(op_type, ins, {out_slot: [out]}, dict(attrs))
    return out


def argsort(x, axis=-1, descending=False):
    return _static_op("argsort", {"X": [x]},
                      {"axis": axis, "descending": descending},
                      out_slot="Indices")


def cumsum(x, axis=-1):
    return _static_op("cumsum", {"X": [x]}, {"axis": axis})


def pow(x, y):
    if isinstance(y, (int, float)):
        return _static_op("pow", {"X": [x]}, {"factor": float(y)})
    return _static_op("elementwise_pow", {"X": [x], "Y": [y]}, {})


def argmin(x, axis=None):
    if axis is None:
        x = _static_op("reshape2", {"X": [x]}, {"shape": [-1]})
        axis = 0
    return _static_op("arg_min", {"X": [x]}, {"axis": axis})


def elu(x, alpha=1.0, name=None):
    return _static_op("elu", {"X": x}, {"alpha": alpha})


def relu6(x, name=None):
    return _static_op("relu6", {"X": x}, {"threshold": 6.0})


for _fn in (argsort, cumsum, pow, argmin, elu, relu6):
    _register(_fn.__name__, _fn)


# --- hand compositions over layers (the reference writes them so) -------

def _compose():
    from .. import layers as L

    def has_nan(x, name=None):
        return globals()["reduce_any"](L.not_equal(x, x))

    def has_inf(x, name=None):
        # inf = non-finite that is not NaN
        bad = globals()["logical_not"](globals()["isfinite"](x))
        notnan = L.equal(x, x)
        return globals()["reduce_any"](globals()["logical_and"](bad, notnan))

    _register("has_nan", has_nan)
    _register("has_inf", has_inf)

    def range_(start, end, step, dtype="int64", name=None):
        def as_var(v):
            return v if hasattr(v, "block") else \
                L.fill_constant([1], dtype, float(v))

        helper = LayerHelper("range", name=name)
        out = helper.create_variable_for_type_inference(dtype)
        helper.append_op("range", {"Start": [as_var(start)],
                                   "End": [as_var(end)],
                                   "Step": [as_var(step)]},
                         {"Out": [out]}, {"dtype": dtype})
        return out

    _register("range", range_)

    # as in the reference, these pass sequence_pool a ``length`` it does
    # not take, and raise TypeError
    def sequence_first_step(input, length=None, name=None):
        return L.sequence_pool(input, "first", length=length)

    def sequence_last_step(input, length=None, name=None):
        return L.sequence_pool(input, "last", length=length)

    _register("sequence_first_step", sequence_first_step)
    _register("sequence_last_step", sequence_last_step)

    def dice_loss(input, label, epsilon=1e-5, name=None):
        label = L.squeeze(label, [-1])
        label = L.one_hot(label, depth=input.shape[-1])
        reduce_dims = list(range(1, len(input.shape)))
        inse = L.reduce_sum(input * label, dim=reduce_dims)
        dice_denominator = L.reduce_sum(input, dim=reduce_dims) + \
            L.reduce_sum(label, dim=reduce_dims)
        dice_score = 1 - inse * 2 / (dice_denominator + epsilon)
        return L.reduce_mean(dice_score)

    _register("dice_loss", dice_loss)

    def smooth_l1(x, y, inside_weight=None, outside_weight=None,
                  sigma=1.0, name=None):
        sigma2 = float(sigma) * float(sigma)
        d = x - y
        if inside_weight is not None:
            d = d * inside_weight
        ad = L.abs(d)
        flag = L.cast(L.less_than(ad, L.fill_constant(
            [1], x.dtype, 1.0 / sigma2)), x.dtype)
        val = flag * 0.5 * sigma2 * d * d + \
            (1.0 - flag) * (ad - 0.5 / sigma2)
        if outside_weight is not None:
            val = val * outside_weight
        return L.reduce_sum(val, dim=[1], keep_dim=True)

    _register("smooth_l1", smooth_l1)

    def mean_iou(input, label, num_classes, name=None):
        pred = L.reshape(input, [-1])
        lab = L.reshape(label, [-1])
        po = L.one_hot(pred, depth=num_classes)
        lo = L.one_hot(lab, depth=num_classes)
        inter = L.reduce_sum(po * lo, dim=[0])
        union = L.reduce_sum(po, dim=[0]) + L.reduce_sum(lo, dim=[0]) \
            - inter
        valid = L.cast(L.greater_than(
            union, L.fill_constant([1], union.dtype, 0.0)), union.dtype)
        iou = inter / (union + 1e-9)
        miou = L.reduce_sum(iou) / (L.reduce_sum(valid) + 1e-9)
        wrong = L.cast(L.reduce_sum(po, dim=[0]) - inter, "int32")
        correct = L.cast(inter, "int32")
        return miou, wrong, correct

    _register("mean_iou", mean_iou)

    def array_length(array, name=None):
        return L.slice(globals()["shape"](array), [0], [0], [1])

    _register("array_length", array_length)

    def soft_relu(x, threshold=40.0, name=None):
        return L.log(1.0 + L.exp(L.clip(x, -float(threshold),
                                        float(threshold))))

    _register("soft_relu", soft_relu)

    def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
        lab = L.reshape(labels, [-1, 1])
        same = L.cast(L.equal(lab, L.transpose(lab, [1, 0])), "float32")
        w = same / L.reduce_sum(same, dim=[1], keep_dim=True)
        sim = L.matmul(anchor, positive, transpose_y=True)
        logp = sim - L.log(L.reduce_sum(L.exp(sim), dim=[1],
                                        keep_dim=True))
        ce = L.reduce_mean(-L.reduce_sum(w * logp, dim=[1]))
        reg = L.reduce_mean(L.reduce_sum(anchor * anchor, dim=[1])
                            + L.reduce_sum(positive * positive, dim=[1])) \
            * (l2_reg * 0.25)
        return ce + reg

    _register("npair_loss", npair_loss)

    def unstack(x, name=None, **attrs):
        helper = LayerHelper("unstack", name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op("unstack", {"X": [x]}, {"Y": [out]}, attrs)
        return out

    _register("unstack", unstack)

    def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                     bias_attr=None, use_peepholes=False,
                     is_reverse=False, gate_activation="sigmoid",
                     cell_activation="tanh", candidate_activation="tanh",
                     dtype="float32", name=None, sequence_length=None):
        """The input is the projected [B, S, 4H] gates: WeightH and Bias
        are created and the lstm op runs without WeightX."""
        h = size // 4
        helper = LayerHelper("dynamic_lstm", name=name)
        wh = helper.create_parameter(param_attr, [h, 4 * h], dtype)
        b = helper.create_parameter(bias_attr, [4 * h], dtype,
                                    is_bias=True)
        outs = {s: [helper.create_variable_for_type_inference(dtype)]
                for s in ("Out", "LastH", "LastC")}
        ins = {"Input": [input], "WeightH": [wh], "Bias": [b]}
        if h_0 is not None:
            ins["H0"] = [h_0]
        if c_0 is not None:
            ins["C0"] = [c_0]
        if sequence_length is not None:
            ins["SequenceLength"] = [sequence_length]
        helper.append_op("lstm", ins, outs, {"is_reverse": is_reverse})
        return outs["Out"][0], outs["LastC"][0]

    _register("dynamic_lstm", dynamic_lstm)

    def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                    is_reverse=False, h_0=None, dtype="float32",
                    name=None, sequence_length=None, **kw):
        """The input is the projected [B, S, 3H] gates."""
        helper = LayerHelper("dynamic_gru", name=name)
        wh = helper.create_parameter(param_attr, [size, 3 * size], dtype)
        b = helper.create_parameter(bias_attr, [3 * size], dtype,
                                    is_bias=True)
        outs = {s: [helper.create_variable_for_type_inference(dtype)]
                for s in ("Out", "LastH")}
        ins = {"Input": [input], "WeightH": [wh], "Bias": [b]}
        if h_0 is not None:
            ins["H0"] = [h_0]
        if sequence_length is not None:
            ins["SequenceLength"] = [sequence_length]
        helper.append_op("gru", ins, outs, {"is_reverse": is_reverse})
        return outs["Out"][0]

    _register("dynamic_gru", dynamic_gru)


_compose()
