"""Device seconds a job of the k-means seeding: the program's
``kmeans.seed`` spans (each call of ``seed_centroids``: k-means++ here), as
:mod:`lanczos_orth_s` reads its spans."""
from specbench.metrics.lanczos_orth_s import seconds_a_job


def read(run):
    return seconds_a_job(run, "kmeans.seed")
