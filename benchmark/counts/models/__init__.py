"""Operations of the encoders' forward passes, one file a model, named as a
configuration's ``model`` names it (``gin.py`` for ``"model": "gin"``)."""
