from repro_torch.data.synthetic import (
    EagletSpec,
    NetflixSpec,
    eaglet_dataset,
    netflix_dataset,
)
