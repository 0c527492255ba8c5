"""The compressed-TM core of the port: the dense model and its oracle
(tm.py), packed-word helpers (bits.py), booleanization (booleanize.py),
the include-only instruction stream (compress.py), the stream interpreter
and the decoded-plan executor (interp.py), the stream protocol and the
paper's base and multi-core accelerators (runtime.py), ``jax.random``'s
threefry streams (prng.py) and training under the reference's seeding
contract (train.py)."""

from .bits import (
    from_u32,
    lshr,
    popcount,
    segmented_and_scan,
    to_u32,
    wrap_i32,
)
from .booleanize import Booleanizer, booleanize_images, to_device_bool
from .compress import (
    CompressedModel,
    DecodedPlan,
    decode,
    decode_to_plan,
    decode_weights,
    encode,
    validate_roundtrip,
)
from .tm import (
    TMConfig,
    batch_class_sums,
    batch_class_sums_weighted,
    class_sums,
    clause_outputs,
    clause_polarities,
    dense_model_bytes,
    include_actions,
    init_state,
    literals,
    pack_literals,
    packed_class_sums,
    predict,
    predict_weighted,
    state_from_actions,
    unpack_bits,
)
from .train import (
    accuracy,
    class_slice_delta,
    fit,
    fit_step,
    sample_class_delta,
    sample_keys,
    train_batch,
    train_batch_parallel,
)

__all__ = [
    "Booleanizer",
    "CompressedModel",
    "DecodedPlan",
    "TMConfig",
    "batch_class_sums",
    "batch_class_sums_weighted",
    "booleanize_images",
    "class_sums",
    "clause_outputs",
    "clause_polarities",
    "decode",
    "decode_to_plan",
    "decode_weights",
    "dense_model_bytes",
    "encode",
    "from_u32",
    "include_actions",
    "init_state",
    "literals",
    "lshr",
    "pack_literals",
    "packed_class_sums",
    "popcount",
    "predict",
    "predict_weighted",
    "segmented_and_scan",
    "state_from_actions",
    "to_device_bool",
    "to_u32",
    "unpack_bits",
    "validate_roundtrip",
    "wrap_i32",
    # training (core.train)
    "accuracy",
    "class_slice_delta",
    "fit",
    "fit_step",
    "sample_class_delta",
    "sample_keys",
    "train_batch",
    "train_batch_parallel",
]
