from .synthetic import synthetic_score
