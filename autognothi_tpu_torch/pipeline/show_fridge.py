"""Debug verb: which parameters of each checkpointed stage are trainable
(port of `autognothi_tpu/pipeline/show_fridge.py`), by the recipe's freeze
rules (`recipe.trainable`).

    python -m autognothi_tpu_torch __show_fridge__ <experiment_dir>

One table per section (classifier, surrogate, explainer, final) with a
checkpoint, newest epoch first found; `rich` draws it where it imports,
plain `train` / `frozen` lines otherwise.  Reads checkpoints only: no
model is built and no device is touched.
"""

from __future__ import annotations

from .env import ExpEnv
from .resources import get_recipe, load_epoch_ckpt


def show_fridge(env: ExpEnv) -> None:
    config = env.config
    recipe, m_config = get_recipe(config)
    sections = {
        "classifier": config.train_classifier.epochs,
        "surrogate": config.train_surrogate.epochs,
        "explainer": config.train_explainer.epochs,
        "final": 0,
    }
    try:
        import rich
        import rich.table

        console = rich.get_console()
    except ImportError:
        console = None

    for section, max_epochs in sections.items():
        epoch, arrays = load_epoch_ckpt(env.model_path, section, max_epochs)
        if arrays is None:
            env.log(f"[[[ no checkpoint for {section} ]]]")
            continue
        trainable = recipe.trainable(m_config, section)
        if console is not None:
            table = rich.table.Table(
                title=f"Fridge Status on `{section}` (epoch {epoch})",
                title_justify="left")
            table.add_column("Name", justify="left")
            table.add_column("Training", justify="left")
            for name in arrays:
                table.add_row(name, "✅" if trainable(name) else "    ")
            console.print(table)
        else:
            for name in arrays:
                flag = "train" if trainable(name) else "frozen"
                print(f"{flag:8s} {section}.{name}")
