from trivy_tpu_torch.license.classifier import (  # noqa: F401
    FullTextClassifier,
    shared_classifier,
)
