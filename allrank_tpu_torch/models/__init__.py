"""Scoring towers: FC input block, slate Transformer encoder, output head
(``factory.LTRModel``)."""
