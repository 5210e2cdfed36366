"""Random-scenario training-data generation: fixed and random bridges, any
mesh size, with the float64 rescue of the lanes the float32 gate rejects;
the 13-key JSON through the native writer and reader, and crash-safe
``.npz`` shards."""

from openpystruct_tpu_torch.datagen.features import (  # noqa: F401
    batch_feature_arrays,
    extract_padded,
)
from openpystruct_tpu_torch.datagen.generate import (  # noqa: F401
    DatagenBatch,
    generate_batch,
    generate_dataset,
    generate_dataset_json,
    generate_to_shards,
    run_batch,
    shard_generator,
    shards_to_json,
)
from openpystruct_tpu_torch.datagen.io import (  # noqa: F401
    SCHEMA_KEYS,
    batch_to_columnar,
    columnar_from_fields,
    merge_columnar,
    read_json_dataset,
    read_npz_shards,
    write_json_dataset,
    write_npz_shard,
)
from openpystruct_tpu_torch.datagen.native import (  # noqa: F401
    JsonStreamWriter,
    native_available,
    read_json_dataset_native,
    reader_available,
    write_json_dataset_native,
)
from openpystruct_tpu_torch.datagen.sampler import sample_scenarios  # noqa: F401
