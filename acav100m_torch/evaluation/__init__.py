"""The evaluation suite: contrastive pretraining and linear evaluation,
counterpart of ``acav100m_tpu.evaluation``."""
