from repro_torch.optim.adafactor import Adafactor, AdafactorState, FactoredMoment
from repro_torch.optim.adamw import AdamW, AdamWState
