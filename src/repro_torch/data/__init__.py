from repro_torch.data.synthetic import (SyntheticClassification,
                                       SyntheticPopulation,
                                       make_classification, make_lm_corpus,
                                       train_test_split)
from repro_torch.data.partition import (dirichlet_partition,
                                        document_partition, iid_partition,
                                        skewed_client_sizes)
from repro_torch.data.calibration import make_calibration_batch
from repro_torch.data.loader import (ClientDataset, ClientSlabStore,
                                     StackedClients, batch_iterator,
                                     data_kind_of,
                                     epoch_batch_indices)
