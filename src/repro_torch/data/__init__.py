from repro_torch.data.synthetic import (mimic_like_dataset, ecg_waveforms,
                                        patients_table, notes_coo)

__all__ = ["mimic_like_dataset", "ecg_waveforms", "patients_table",
           "notes_coo"]
