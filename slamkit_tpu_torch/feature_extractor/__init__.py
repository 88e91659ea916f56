from .audio_feature_extractor import AudioFeatureExtractor
from .hubert import HubertConfig
from .hubert_feature_extractor import HUBERT_CONFIG_PRESETS, HubertFeatureExtractor
from .kmeans import (assign_clusters, kmeans_fit, load_kmeans_centroids,
                     save_kmeans_centroids)

__all__ = ["AudioFeatureExtractor", "HubertConfig", "HUBERT_CONFIG_PRESETS",
           "HubertFeatureExtractor", "assign_clusters", "kmeans_fit", "load_kmeans_centroids",
           "save_kmeans_centroids"]
