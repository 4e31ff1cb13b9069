"""Correspondence retrieval: the ground-truth correctness suite (paired
views with a known matched set, derangement, clustering, selection,
precision/recall/F1), counterpart of ``acav100m_tpu.retrieval``."""
