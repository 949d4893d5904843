"""The paper's own architecture (Table 1): GSC keyword-spotting CNN."""

from repro_torch.models.gsc_cnn import GSCConfig

CONFIG = GSCConfig()
