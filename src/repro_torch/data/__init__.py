from repro_torch.data.pipeline import SyntheticData, partition_batch_specs

__all__ = ["SyntheticData", "partition_batch_specs"]
