from repro_torch.data.pipeline import (  # noqa: F401
    PipelineConfig,
    SubsamplingBatchPipeline,
    tune_microbatch_tokens,
)
from repro_torch.data.synthetic import (  # noqa: F401
    EagletSpec,
    NetflixSpec,
    eaglet_dataset,
    lm_token_corpus,
    netflix_dataset,
)
