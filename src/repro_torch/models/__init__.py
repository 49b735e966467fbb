from repro_torch.models.small import (logreg_apply, logreg_init, logreg_loss,
                                      mlp_apply, mlp_init, mlp_loss)

__all__ = ["logreg_apply", "logreg_init", "logreg_loss",
           "mlp_apply", "mlp_init", "mlp_loss"]
