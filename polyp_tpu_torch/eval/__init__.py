from polyp_tpu_torch.eval.metrics import (  # noqa: F401
    accuracy_score,
    classification_report,
    confusion_matrix,
    precision_recall_f1,
)
from polyp_tpu_torch.eval.quota import (  # noqa: F401
    counts_per_class,
    get_num_images_to_generate,
)
