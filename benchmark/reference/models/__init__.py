"""Plain encoders, one file a model, named as a configuration's ``model``
names it (``gin.py`` for ``"model": "gin"``)."""
