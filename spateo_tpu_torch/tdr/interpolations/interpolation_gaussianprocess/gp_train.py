"""GP training loop front end (parity surface: reference gp_train.py
gp_train): the lightning/gpytorch loop is the SGPR fit of the model."""

from __future__ import annotations


def gp_train(model, train_loader=None, train_epochs: int = 200, method: str = "SVGP", N: int = None, device="cuda",
             keys=None, verbose: bool = True):
    """Train a gp_models model (parity: reference gp_train.py); the model
    runs on its own device."""
    if hasattr(model, "fit") and train_loader is not None:
        X, Y = train_loader
        return model.fit(X, Y, n_epochs=train_epochs)
    if hasattr(model, "fit"):
        return model.fit()
    return model
