"""Shared preprocessing pipeline (the reference's L3 layer): the host numpy
pipeline, its on-device mirror, and the scalers saved to and loaded from
disk."""

from openpystruct_tpu_torch.data.device_pipeline import (  # noqa: F401
    prepare_dataset_device,
)
from openpystruct_tpu_torch.data.persist import (  # noqa: F401
    load_preprocessing,
    save_preprocessing,
)
from openpystruct_tpu_torch.data.pipeline import (  # noqa: F401
    DatasetSplits,
    Scaler,
    build_user_input,
    fit_transform_3d,
    merge_sub_features,
    pad_feat_dim_to_multiple_of_nheads,
    pad_sequences,
    prepare_dataset,
    transform_3d,
    unify_label,
)
