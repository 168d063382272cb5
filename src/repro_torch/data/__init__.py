from repro_torch.data.synthetic import (mimic_like_dataset, ecg_waveforms,
                                        patients_table, notes_coo)
from repro_torch.data.tokens import TokenStream
from repro_torch.data.loader import ShardedLoader

__all__ = ["mimic_like_dataset", "ecg_waveforms", "patients_table",
           "notes_coo", "TokenStream", "ShardedLoader"]
