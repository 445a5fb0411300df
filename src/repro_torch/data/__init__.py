from repro_torch.data.synthetic import (SyntheticClassification,
                                       make_classification, train_test_split)
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.calibration import make_calibration_batch
from repro_torch.data.loader import ClientDataset, epoch_batch_indices
